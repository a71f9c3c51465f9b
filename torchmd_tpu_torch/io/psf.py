"""CHARMM/X-PLOR PSF topology reader.

Replaces the `moleculekit` PSF path used by the reference
(tests/test_torchmd.py:347, torchmd/run.py:158-159).
Parses atoms (segid, resid, resname, name, type, charge, mass) and the
bond/angle/dihedral/improper index sections.
"""

from __future__ import annotations

import numpy as np


def _read_index_section(tokens: list[str], count: int, arity: int) -> np.ndarray:
    vals = np.array(tokens[: count * arity], dtype=np.int64) - 1  # 1-based -> 0-based
    return vals.reshape(count, arity)


def read_psf(path: str) -> dict:
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        lines = f.readlines()

    i = 0
    natom = 0
    out: dict = {}
    sections = {
        "!NBOND": ("bonds", 2),
        "!NTHETA": ("angles", 3),
        "!NPHI": ("dihedrals", 4),
        "!NIMPHI": ("impropers", 4),
        "!NCRTERM": ("crossterms", 8),  # CMAP cross-terms (CHARMM36)
    }

    while i < len(lines):
        line = lines[i]
        if "!NATOM" in line:
            natom = int(line.split()[0])
            segid, resid, resname, name, atomtype = [], [], [], [], []
            charge, mass = [], []
            for j in range(natom):
                parts = lines[i + 1 + j].split()
                # serial segid resid resname name type charge mass imove
                segid.append(parts[1])
                try:
                    resid.append(int(parts[2]))
                except ValueError:
                    resid.append(0)
                resname.append(parts[3])
                name.append(parts[4])
                atomtype.append(parts[5])
                charge.append(float(parts[6]))
                mass.append(float(parts[7]))
            out["segid"] = np.array(segid, dtype=object)
            out["resid"] = np.array(resid, dtype=np.int64)
            out["resname"] = np.array(resname, dtype=object)
            out["name"] = np.array(name, dtype=object)
            out["atomtype"] = np.array(atomtype, dtype=object)
            out["charge"] = np.array(charge, dtype=np.float64)
            out["masses"] = np.array(mass, dtype=np.float64)
            i += natom + 1
            continue
        for tag, (key, arity) in sections.items():
            if tag in line:
                count = int(line.split()[0])
                tokens: list[str] = []
                j = i + 1
                while len(tokens) < count * arity and j < len(lines):
                    tokens.extend(lines[j].split())
                    j += 1
                out[key] = _read_index_section(tokens, count, arity)
                i = j - 1
                break
        i += 1

    for key, arity in (("bonds", 2), ("angles", 3), ("dihedrals", 4),
                       ("impropers", 4), ("crossterms", 8)):
        if key not in out:
            out[key] = np.zeros((0, arity), dtype=np.int64)

    from .periodictable import element_from_name

    out["element"] = np.array(
        [element_from_name(n) for n in out.get("name", [])], dtype=object
    )
    return out
