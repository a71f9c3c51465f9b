"""AMBER PRMTOP reader.

Self-contained replacement for the `parmed.amber.AmberParm` +
`moleculekit` path the reference uses for AMBER systems
(torchmd/forcefields/ff_parmed.py:38-40, tests/test_torchmd.py:349,387).

Parses the %FLAG/%FORMAT card format and exposes:
  - per-atom arrays: names, atomtype, charge (e, i.e. CHARGE/18.2223),
    masses, atomic numbers
  - topology index lists: bonds, angles, dihedrals, impropers
    (AMBER stores packed 3*i indices; fourth index < 0 marks impropers,
    third index < 0 marks dihedrals whose 1-4 interaction is excluded)
  - parameter tables: bond/angle/dihedral type constants, LJ ACOEF/BCOEF,
    SCEE/SCNB per dihedral type.

AMBER angle equilibrium values and dihedral phases are already in radians.
Charges are stored in internal units (e * 18.2223).
"""

from __future__ import annotations

import numpy as np

AMBER_CHARGE_FACTOR = 18.2223


def _parse_sections(path: str) -> dict[str, list[str]]:
    sections: dict[str, list[str]] = {}
    current = None
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for raw in f:
            line = raw.rstrip("\n")
            if line.startswith("%FLAG"):
                current = line.split()[1]
                sections[current] = []
            elif line.startswith("%FORMAT") or line.startswith("%COMMENT"):
                if current is not None:
                    sections.setdefault(current + "__FORMAT", []).append(line)
            elif line.startswith("%VERSION"):
                continue
            elif current is not None:
                sections[current].append(line)
    return sections


def _floats(lines: list[str]) -> np.ndarray:
    return np.array("\n".join(lines).split(), dtype=np.float64)


def _ints(lines: list[str]) -> np.ndarray:
    toks: list[str] = []
    for ln in lines:
        toks.extend(ln.split())
    return np.array(toks, dtype=np.int64) if toks else np.zeros(0, dtype=np.int64)


def _fixed_width_strings(lines: list[str], width: int = 4) -> list[str]:
    out = []
    for ln in lines:
        for i in range(0, len(ln), width):
            chunk = ln[i : i + width]
            if chunk.strip() or (i + width <= 80 and chunk):
                out.append(chunk.strip())
    return out


class Prmtop:
    def __init__(self, path: str):
        sec = _parse_sections(path)
        self._sec = sec

        pointers = _ints(sec["POINTERS"])
        self.natoms = int(pointers[0])
        self.ntypes = int(pointers[1])
        (
            self.nbonh,
            self.mbona,
            self.ntheth,
            self.mtheta,
            self.nphih,
            self.mphia,
        ) = (int(x) for x in pointers[2:8])
        self.nbona = int(pointers[12])
        self.ntheta = int(pointers[13])
        self.nphia = int(pointers[14])
        self.numbnd = int(pointers[15])
        self.numang = int(pointers[16])
        self.nptra = int(pointers[17])

        n = self.natoms
        self.atom_name = np.array(
            _fixed_width_strings(sec["ATOM_NAME"])[:n], dtype=object
        )
        self.atomtype = np.array(
            _fixed_width_strings(sec["AMBER_ATOM_TYPE"])[:n], dtype=object
        )
        self.charge = _floats(sec["CHARGE"])[:n] / AMBER_CHARGE_FACTOR
        self.masses = _floats(sec["MASS"])[:n]
        if "ATOMIC_NUMBER" in sec:
            self.atomic_number = _ints(sec["ATOMIC_NUMBER"])[:n]
        else:
            self.atomic_number = np.zeros(n, dtype=np.int64)
        self.atom_type_index = _ints(sec["ATOM_TYPE_INDEX"])[:n] - 1  # 0-based
        self.nb_parm_index = _ints(sec["NONBONDED_PARM_INDEX"]) - 1
        self.lj_acoef = _floats(sec["LENNARD_JONES_ACOEF"])
        self.lj_bcoef = _floats(sec["LENNARD_JONES_BCOEF"])

        self.bond_k = _floats(sec["BOND_FORCE_CONSTANT"])
        self.bond_req = _floats(sec["BOND_EQUIL_VALUE"])
        self.angle_k = _floats(sec["ANGLE_FORCE_CONSTANT"])
        self.angle_teq = _floats(sec["ANGLE_EQUIL_VALUE"])  # radians
        self.dihedral_k = _floats(sec["DIHEDRAL_FORCE_CONSTANT"])
        self.dihedral_per = _floats(sec["DIHEDRAL_PERIODICITY"])
        self.dihedral_phase = _floats(sec["DIHEDRAL_PHASE"])  # radians
        if "SCEE_SCALE_FACTOR" in sec:
            self.scee = _floats(sec["SCEE_SCALE_FACTOR"])
        else:
            self.scee = np.full(self.nptra, 1.2)
        if "SCNB_SCALE_FACTOR" in sec:
            self.scnb = _floats(sec["SCNB_SCALE_FACTOR"])
        else:
            self.scnb = np.full(self.nptra, 2.0)

        bh = _ints(sec.get("BONDS_INC_HYDROGEN", []))
        ba = _ints(sec.get("BONDS_WITHOUT_HYDROGEN", []))
        ah = _ints(sec.get("ANGLES_INC_HYDROGEN", []))
        aa = _ints(sec.get("ANGLES_WITHOUT_HYDROGEN", []))
        dh = _ints(sec.get("DIHEDRALS_INC_HYDROGEN", []))
        da = _ints(sec.get("DIHEDRALS_WITHOUT_HYDROGEN", []))

        bonds_raw = np.concatenate([bh.reshape(-1, 3), ba.reshape(-1, 3)], axis=0)
        angles_raw = np.concatenate([ah.reshape(-1, 4), aa.reshape(-1, 4)], axis=0)
        dihed_raw = np.concatenate([dh.reshape(-1, 5), da.reshape(-1, 5)], axis=0)

        self.bonds = (bonds_raw[:, :2] // 3).astype(np.int64)
        self.bond_type = bonds_raw[:, 2] - 1
        self.angles = (angles_raw[:, :3] // 3).astype(np.int64)
        self.angle_type = angles_raw[:, 3] - 1

        # Dihedral rows: (i, j, k, l, type). k < 0 -> 1-4 excluded for this
        # term; l < 0 -> improper torsion. Atom index = |packed| // 3.
        ijkl = np.abs(dihed_raw[:, :4]) // 3
        is_improper = dihed_raw[:, 3] < 0
        self.all_dihedral_rows = ijkl.astype(np.int64)
        self.all_dihedral_types = (dihed_raw[:, 4] - 1).astype(np.int64)
        self.dihedral_is_improper = is_improper
        self.dihedral_14_excluded = dihed_raw[:, 2] < 0

        self.dihedrals = self.all_dihedral_rows[~is_improper]
        self.dihedral_types_per_row = self.all_dihedral_types[~is_improper]
        self.impropers = self.all_dihedral_rows[is_improper]
        self.improper_types_per_row = self.all_dihedral_types[is_improper]

        if "BOX_DIMENSIONS" in sec and len(sec["BOX_DIMENSIONS"]):
            vals = _floats(sec["BOX_DIMENSIONS"])
            self.box = vals[1:4] if len(vals) >= 4 else None
        else:
            self.box = None

    @property
    def gb_radii(self) -> np.ndarray:
        """Per-atom intrinsic GB radii [A] (RADII section; Amber's own
        mbondi/mbondi2 values selected at tleap time)."""
        return _floats(self._sec["RADII"])[: self.natoms]

    @property
    def gb_screen(self) -> np.ndarray:
        """Per-atom HCT screening factors (SCREEN section)."""
        return _floats(self._sec["SCREEN"])[: self.natoms]

    def lj_diag(self, type_idx: int) -> tuple[float, float]:
        """(rmin/2, epsilon) for one nonbonded type index, from the ACOEF/BCOEF
        diagonal (same extraction parmed performs in AmberParm.fill_LJ)."""
        pi = self.nb_parm_index[self.ntypes * type_idx + type_idx]
        a = self.lj_acoef[pi]
        b = self.lj_bcoef[pi]
        if a == 0.0 or b == 0.0:
            return 0.5, 0.0
        rmin2 = 0.5 * (2.0 * a / b) ** (1.0 / 6.0)
        eps = b * b / (4.0 * a)
        return rmin2, eps
