"""GROMACS .gro coordinate file reader/writer.

New capability beyond the reference (which reads coordinates only through
moleculekit: pdb/xtc/coor -- torchmd/run.py:158-175). The .gro format is
the native GROMACS coordinate container: fixed-column atom records in
nanometers plus a final box line (3 floats for a rectangular box, 9 for
triclinic). Everything is converted to the framework's Angstrom
conventions on read.

Format (one frame):
  line 1: free-form title (may end in 't= <time>')
  line 2: atom count
  atoms : resid(5) resname(5) atomname(5) atomnr(5) x y z [vx vy vz]
          positions %8.3f in nm, velocities %8.4f in nm/ps
  last  : box vectors in nm: "v1x v2y v3z [v1y v1z v2x v2z v3x v3y]"
"""

from __future__ import annotations

import numpy as np

NM2ANG = 10.0


def read_gro(filename):
    """Parse a .gro file -> dict with name/resname/resid, coords (natoms,3,1)
    in Angstrom, optional velocities (natoms,3) in Angstrom/ps, and box
    (3,1) Angstrom diagonal. Raises on triclinic boxes (off-diagonal box
    vector components): the framework supports rectangular cells."""
    with open(filename) as fh:
        lines = fh.read().splitlines()
    if len(lines) < 3:
        raise ValueError(f"{filename}: truncated .gro file")
    natoms = int(lines[1].split()[0])
    if len(lines) < natoms + 3:
        raise ValueError(
            f"{filename}: expected {natoms} atom lines, file too short"
        )

    resid = np.zeros(natoms, dtype=np.int64)
    resname = np.zeros(natoms, dtype=object)
    name = np.zeros(natoms, dtype=object)
    coords = np.zeros((natoms, 3), dtype=np.float64)
    vels = np.zeros((natoms, 3), dtype=np.float64)
    has_vel = False
    for i in range(natoms):
        ln = lines[2 + i]
        resid[i] = int(ln[0:5])
        resname[i] = ln[5:10].strip()
        name[i] = ln[10:15].strip()
        # Columns after the serial are fixed width but the width of the
        # position fields can exceed %8.3f for large coordinates written
        # by other tools; split the tail instead of slicing.
        fields = ln[20:].split()
        coords[i] = [float(v) for v in fields[0:3]]
        if len(fields) >= 6:
            vels[i] = [float(v) for v in fields[3:6]]
            has_vel = True

    bf = [float(v) for v in lines[2 + natoms].split()]
    if len(bf) not in (3, 9):
        raise ValueError(f"{filename}: malformed box line {bf}")
    if len(bf) == 9 and any(abs(v) > 1e-9 for v in bf[3:]):
        raise ValueError(
            f"{filename}: triclinic box (off-diagonal components {bf[3:]}); "
            "only rectangular boxes are supported"
        )
    box = np.asarray(bf[:3], dtype=np.float64) * NM2ANG

    return {
        "resid": resid,
        "resname": resname,
        "name": name,
        "coords": (coords * NM2ANG)[:, :, None],
        "velocities": vels * NM2ANG if has_vel else None,
        "box": box.reshape(3, 1),
    }


def write_gro(filename, mol, frame=0, title="written by torchmd-tpu"):
    """Write one frame of a Molecule to .gro (Angstrom -> nm)."""
    n = mol.numAtoms
    coords = np.asarray(mol.coords[:, :, frame], dtype=np.float64) / NM2ANG
    resid = (
        np.asarray(mol.resid)
        if len(getattr(mol, "resid", [])) == n
        else np.ones(n, dtype=np.int64)
    )
    resname = (
        np.asarray(mol.resname)
        if len(getattr(mol, "resname", [])) == n
        else np.array(["MOL"] * n, dtype=object)
    )
    names = (
        np.asarray(mol.name)
        if len(getattr(mol, "name", [])) == n
        else np.array([f"A{i}" for i in range(n)], dtype=object)
    )
    bx = np.asarray(mol.box[:, min(frame, mol.box.shape[1] - 1)]) / NM2ANG
    with open(filename, "w") as fh:
        fh.write(f"{title}\n{n}\n")
        for i in range(n):
            fh.write(
                f"{int(resid[i]) % 100000:5d}{str(resname[i])[:5]:<5s}"
                f"{str(names[i])[:5]:>5s}{(i + 1) % 100000:5d}"
                f"{coords[i, 0]:8.3f}{coords[i, 1]:8.3f}{coords[i, 2]:8.3f}\n"
            )
        fh.write(f"{bx[0]:10.5f}{bx[1]:10.5f}{bx[2]:10.5f}\n")
