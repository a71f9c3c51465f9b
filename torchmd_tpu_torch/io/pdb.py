"""PDB reader/writer (topology-lite: names, elements, coords, CONECT bonds, CRYST1).

Self-contained replacement for the slice of `moleculekit` the reference uses
(reference call sites: torchmd/run.py:158-166, tests/test_torchmd.py:354-355).
"""

from __future__ import annotations

import numpy as np


def read_pdb(path: str) -> dict:
    """Parse a PDB file.

    Returns a dict with: name, resname, resid, segid, element, coords
    (natoms, 3, nframes), bonds (nb, 2) from CONECT, crystalinfo (dict or None).
    """
    names, resnames, resids, segids, elements = [], [], [], [], []
    frames: list[list[tuple]] = [[]]
    bonds = set()
    crystalinfo = None
    in_model = 0

    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            rec = line[:6]
            if rec in ("ATOM  ", "HETATM"):
                if in_model >= len(frames):
                    frames.append([])
                x = float(line[30:38])
                y = float(line[38:46])
                z = float(line[46:54])
                frames[in_model].append((x, y, z))
                if in_model == 0:
                    names.append(line[12:16].strip())
                    resnames.append(line[17:21].strip())
                    try:
                        resids.append(int(line[22:26]))
                    except ValueError:
                        resids.append(0)
                    segids.append(line[72:76].strip())
                    el = line[76:78].strip() if len(line) > 76 else ""
                    elements.append(el)
            elif rec == "CONECT":
                fields = line[6:].rstrip("\n")
                idxs = [
                    int(fields[i : i + 5])
                    for i in range(0, len(fields) - 4, 5)
                    if fields[i : i + 5].strip()
                ]
                if len(idxs) >= 2:
                    a = idxs[0] - 1
                    for b in idxs[1:]:
                        pair = (min(a, b - 1), max(a, b - 1))
                        bonds.add(pair)
            elif rec == "CRYST1":
                try:
                    crystalinfo = {
                        "a": float(line[6:15]),
                        "b": float(line[15:24]),
                        "c": float(line[24:33]),
                        "alpha": float(line[33:40]),
                        "beta": float(line[40:47]),
                        "gamma": float(line[47:54]),
                    }
                except ValueError:
                    crystalinfo = None
            elif rec.startswith("ENDMDL"):
                in_model += 1

    frames = [fr for fr in frames if len(fr)]
    natoms = len(frames[0]) if frames else 0
    coords = np.zeros((natoms, 3, max(1, len(frames))), dtype=np.float64)
    for k, fr in enumerate(frames):
        if len(fr) != natoms:
            break  # ignore truncated trailing models
        coords[:, :, k] = np.asarray(fr, dtype=np.float64)

    from .periodictable import element_from_name

    elements = [
        el if el else element_from_name(nm) for el, nm in zip(elements, names)
    ]

    return {
        "name": np.array(names, dtype=object),
        "resname": np.array(resnames, dtype=object),
        "resid": np.array(resids, dtype=np.int64),
        "segid": np.array(segids, dtype=object),
        "element": np.array(elements, dtype=object),
        "coords": coords,
        "bonds": np.array(sorted(bonds), dtype=np.int64).reshape(-1, 2),
        "crystalinfo": crystalinfo,
    }


def write_pdb(path: str, mol, frame: int = 0) -> None:
    """Write a minimal single-frame PDB from a Molecule-like object."""
    coords = np.asarray(mol.coords)
    if coords.ndim == 3:
        coords = coords[:, :, frame]
    with open(path, "w", encoding="utf-8") as f:
        if getattr(mol, "box", None) is not None and np.any(np.asarray(mol.box) != 0):
            b = np.asarray(mol.box).reshape(3, -1)[:, 0]
            f.write(
                f"CRYST1{b[0]:9.3f}{b[1]:9.3f}{b[2]:9.3f}"
                f"{90.0:7.2f}{90.0:7.2f}{90.0:7.2f} P 1           1\n"
            )
        def field(attr, i, default):
            v = getattr(mol, attr, None)
            return str(v[i]) if v is not None and len(v) > i else default

        for i in range(coords.shape[0]):
            name = field("name", i, "X")[:4]
            resname = field("resname", i, "UNK")[:4]
            el = field("element", i, "")[:2]
            f.write(
                f"ATOM  {min(i + 1, 99999):5d} {name:<4s}{resname:<4s} "
                f"{1:4d}    {coords[i, 0]:8.3f}{coords[i, 1]:8.3f}{coords[i, 2]:8.3f}"
                f"{1.0:6.2f}{0.0:6.2f}          {el:>2s}\n"
            )
        f.write("END\n")
