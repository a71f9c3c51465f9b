"""AMBER force field from PRMTOP (and FRCMOD) files.

Self-contained replacement for the reference's
`parmed.amber.AmberParameterSet.from_structure` route
(torchmd/forcefields/ff_parmed.py:33-42): per-instance parameter tables in
the prmtop are lifted into type-name-keyed tables, so parameter assembly by
unique atom-type tuples reproduces the reference numerics exactly.

Notes:
  - sigma/epsilon come from the LENNARD_JONES_ACOEF/BCOEF diagonal
    (sigma = (A/B)^(1/6), eps = B^2/(4A)); zero rows give eps = 0.
  - AMBER angle equilibria and dihedral phases are already radians.
  - Improper (periodic) keys are canonicalized with the central (third)
    atom fixed at position 2 and the remaining three sorted, which the
    center-fixed permutation lookup recovers.
  - scee/scnb per dihedral type from SCEE/SCNB_SCALE_FACTOR (defaults
    1.2 / 2.0).
"""

from __future__ import annotations

from itertools import permutations

import numpy as np

from .forcefield import _ForceFieldBase

_SIGMA_PER_RMIN2 = 2.0 ** (5.0 / 6.0)


def _improper_key(t1, t2, t3, t4):
    rest = sorted([t1, t2, t4])
    return (rest[0], rest[1], t3, rest[2])


class AmberParameterSet:
    """Type-name-keyed parameter tables built from a parsed Prmtop."""

    def __init__(self, top):
        self.top = top
        at = top.atomtype

        self.atom_types: dict[str, tuple] = {}  # name -> (sigma, eps)
        for i in range(top.natoms):
            name = at[i]
            if name not in self.atom_types:
                rmin2, eps = top.lj_diag(int(top.atom_type_index[i]))
                self.atom_types[name] = (rmin2 * _SIGMA_PER_RMIN2, eps)

        self.bond_types: dict[tuple, tuple] = {}
        for (i, j), t in zip(top.bonds, top.bond_type):
            key = (at[i], at[j])
            val = (float(top.bond_k[t]), float(top.bond_req[t]))
            self.bond_types[key] = val
            self.bond_types[key[::-1]] = val

        self.angle_types: dict[tuple, tuple] = {}
        for (i, j, k), t in zip(top.angles, top.angle_type):
            key = (at[i], at[j], at[k])
            val = (float(top.angle_k[t]), float(top.angle_teq[t]))
            self.angle_types[key] = val
            self.angle_types[key[::-1]] = val

        # Proper dihedrals: multi-term lists per type quad, deduplicated the
        # way parmed's from_structure does (append term if not present).
        self.dihedral_types: dict[tuple, list] = {}
        for row, t in zip(top.dihedrals, top.dihedral_types_per_row):
            key = tuple(at[x] for x in row)
            if key not in self.dihedral_types and key[::-1] in self.dihedral_types:
                key = key[::-1]
            lst = self.dihedral_types.setdefault(key, [])
            term = (
                float(top.dihedral_k[t]),
                float(top.dihedral_per[t]),
                float(top.dihedral_phase[t]),  # radians
                float(top.scee[t]) if t < len(top.scee) else 1.2,
                float(top.scnb[t]) if t < len(top.scnb) else 2.0,
            )
            if term not in lst:
                lst.append(term)

        self.improper_periodic_types: dict[tuple, tuple] = {}
        for row, t in zip(top.impropers, top.improper_types_per_row):
            key = _improper_key(*(at[x] for x in row))
            self.improper_periodic_types[key] = (
                float(top.dihedral_k[t]),
                float(top.dihedral_per[t]),
                float(top.dihedral_phase[t]),  # radians
            )
        self.improper_types: dict[tuple, tuple] = {}  # no harmonic impropers in AMBER


class AmberFrcmodParameterSet:
    """AMBER .frcmod parameter modification file parser.

    Covers the sections parmed reads for the reference's frcmod path
    (ff_parmed.py:41-42): MASS, BOND, ANGLE (deg), DIHE (with IDIVF
    divider, SCEE=/SCNB= annotations, negative-periodicity multi-term
    continuation), IMPROPER (center third), NONBON (Rmin/2 + epsilon).
    Angles/phases are converted to radians at the getter level like the
    prmtop tables.
    """

    def __init__(self, fname: str):
        self.masses: dict[str, float] = {}
        self.atom_types: dict[str, tuple] = {}   # name -> (sigma, eps)
        self.bond_types: dict[tuple, tuple] = {}
        self.angle_types: dict[tuple, tuple] = {}
        self.dihedral_types: dict[tuple, list] = {}
        self.improper_periodic_types: dict[tuple, tuple] = {}
        self.improper_types: dict[tuple, tuple] = {}
        self._parse(fname)

    @staticmethod
    def _split_types(line: str, ntypes: int) -> tuple[tuple, list]:
        """Extract the dash-joined type field (which may embed spaces for
        short names, e.g. 'C -N -CT-C ') and the remaining numeric tokens."""
        # token style first: the whole type field is one token (gaff-style
        # "ca-ca-ca-ce 1 3.625 ...")
        parts = line.split()
        key = tuple(t.strip() for t in parts[0].split("-"))
        if len(key) == ntypes and all(key):
            return key, parts[1:]
        # classic fixed-width field with embedded spaces ("C -N -CT-C "):
        # ntypes 2-char fields joined by "-" -> 3*ntypes - 1 columns
        width = 3 * ntypes - 1
        head = line[:width]
        key = tuple(t.strip() for t in head.split("-"))
        if len(key) == ntypes and all(key):
            return key, line[width:].split()
        raise ValueError(f"Cannot parse {ntypes}-type field: {line!r}")

    def _parse(self, fname):
        import math
        import re

        section = None
        pending_key = None
        with open(fname, "r", encoding="utf-8", errors="replace") as f:
            lines = f.readlines()
        for k, raw in enumerate(lines):
            line = raw.rstrip("\n")
            up = line.strip().upper()
            if k == 0:
                continue  # title line
            if up[:4] in ("MASS", "BOND", "ANGL", "DIHE", "IMPR", "NONB",
                          "HBON") or up == "END":
                section = up[:4] if up != "END" else None
                pending_key = None
                continue
            if not line.strip():
                pending_key = None
                continue
            try:
                if section == "MASS":
                    parts = line.split()
                    self.masses[parts[0]] = float(parts[1])
                elif section == "BOND":
                    key, vals = self._split_types(line, 2)
                    v = (float(vals[0]), float(vals[1]))
                    self.bond_types[key] = v
                    self.bond_types[key[::-1]] = v
                elif section == "ANGL":
                    key, vals = self._split_types(line, 3)
                    v = (float(vals[0]), math.radians(float(vals[1])))
                    self.angle_types[key] = v
                    self.angle_types[key[::-1]] = v
                elif section == "DIHE":
                    # types IDIVF PK PHASE PN [scee scnb | SCEE=x SCNB=y];
                    # negative PN marks a multi-term continuation
                    key, vals = self._split_types(line, 4)
                    idivf = float(vals[0])
                    pk = float(vals[1]) / idivf
                    phase = math.radians(float(vals[2]))
                    per = float(vals[3])
                    scee, scnb = 1.2, 2.0
                    m = re.search(r"SCEE\s*=?\s*([\d.]+)", line, re.I)
                    if m:
                        scee = float(m.group(1))
                    elif len(vals) >= 5:
                        scee = float(vals[4])
                    m = re.search(r"SCNB\s*=?\s*([\d.]+)", line, re.I)
                    if m:
                        scnb = float(m.group(1))
                    elif len(vals) >= 6:
                        scnb = float(vals[5])
                    if key not in self.dihedral_types and key[::-1] in self.dihedral_types:
                        key = key[::-1]
                    continuing = pending_key == key
                    if key in self.dihedral_types and not continuing:
                        self.dihedral_types[key] = []  # re-definition replaces
                    lst = self.dihedral_types.setdefault(key, [])
                    lst.append((pk, abs(per), phase, scee, scnb))
                    pending_key = key if per < 0 else None
                elif section == "IMPR":
                    key0, vals = self._split_types(line, 4)
                    key = _improper_key(key0[0], key0[1], key0[2], key0[3])
                    self.improper_periodic_types[key] = (
                        float(vals[0]),
                        float(vals[2]),
                        math.radians(float(vals[1])),
                    )
                elif section == "NONB":
                    parts = line.split()
                    rmin2 = float(parts[1])
                    eps = abs(float(parts[2]))
                    self.atom_types[parts[0]] = (
                        rmin2 * _SIGMA_PER_RMIN2, eps
                    )
            except (ValueError, IndexError):
                pending_key = None
                continue


class AmberParmDatParameterSet:
    """AMBER base parameter file (parm99.dat / gaff.dat layout).

    The classic sequential format (no named sections): title line; atom
    symbols + masses (blank-terminated); one hydrophilic-types line;
    bonds; angles (deg); dihedrals (IDIVF PK PHASE PN, negative PN =
    multi-term continuation, X wildcards); impropers (PK PHASE PN, X
    wildcards, center third); H-bond 10-12 rows; vdW equivalence lines;
    a KINDNB label line; vdW entries (Rmin/2, epsilon) closed by END.
    Completes the reference's AMBER path, which could only modify
    prmtop-derived tables via frcmod (ff_parmed.py:33-42)."""

    def __init__(self, fname: str):
        self.masses: dict[str, float] = {}
        self.atom_types: dict[str, tuple] = {}   # name -> (sigma, eps)
        self.bond_types: dict[tuple, tuple] = {}
        self.angle_types: dict[tuple, tuple] = {}
        self.dihedral_types: dict[tuple, list] = {}
        self.improper_periodic_types: dict[tuple, tuple] = {}
        self.improper_types: dict[tuple, tuple] = {}
        self.equivalences: dict[str, str] = {}   # alias -> canonical vdW
        self._parse(fname)

    _split_types = staticmethod(AmberFrcmodParameterSet._split_types)

    def _parse(self, fname):
        import math
        import re

        with open(fname, "r", encoding="utf-8", errors="replace") as f:
            lines = [ln.rstrip("\n") for ln in f.readlines()]

        # sequential section cursor
        i = 1  # skip title
        # --- atom masses ---
        while i < len(lines) and lines[i].strip():
            parts = lines[i].split()
            try:
                self.masses[parts[0]] = float(parts[1])
            except (ValueError, IndexError):
                pass
            i += 1
        i += 1
        # --- hydrophilic-types line (single, may be blank in some files) ---
        if i < len(lines) and "-" not in lines[i][:5]:
            i += 1
        # --- bonds ---
        while i < len(lines) and lines[i].strip():
            try:
                key, vals = self._split_types(lines[i], 2)
                v = (float(vals[0]), float(vals[1]))
                self.bond_types[key] = v
                self.bond_types[key[::-1]] = v
            except (ValueError, IndexError):
                pass
            i += 1
        i += 1
        # --- angles ---
        while i < len(lines) and lines[i].strip():
            try:
                key, vals = self._split_types(lines[i], 3)
                v = (float(vals[0]), math.radians(float(vals[1])))
                self.angle_types[key] = v
                self.angle_types[key[::-1]] = v
            except (ValueError, IndexError):
                pass
            i += 1
        i += 1
        # --- proper dihedrals ---
        pending_key = None
        while i < len(lines) and lines[i].strip():
            try:
                key, vals = self._split_types(lines[i], 4)
                idivf = float(vals[0])
                pk = float(vals[1]) / idivf
                phase = math.radians(float(vals[2]))
                per = float(vals[3])
                scee, scnb = 1.2, 2.0
                m = re.search(r"SCEE\s*=?\s*([\d.]+)", lines[i], re.I)
                if m:
                    scee = float(m.group(1))
                m = re.search(r"SCNB\s*=?\s*([\d.]+)", lines[i], re.I)
                if m:
                    scnb = float(m.group(1))
                if key not in self.dihedral_types and key[::-1] in self.dihedral_types:
                    key = key[::-1]
                continuing = pending_key == key
                if key in self.dihedral_types and not continuing:
                    self.dihedral_types[key] = []
                self.dihedral_types.setdefault(key, []).append(
                    (pk, abs(per), phase, scee, scnb)
                )
                pending_key = key if per < 0 else None
            except (ValueError, IndexError):
                pending_key = None
            i += 1
        i += 1
        # --- impropers (PK PHASE PN, no IDIVF; center is the third type) ---
        while i < len(lines) and lines[i].strip():
            try:
                key, vals = self._split_types(lines[i], 4)
                self.improper_periodic_types[key] = (
                    float(vals[0]),
                    float(vals[2]),
                    math.radians(float(vals[1])),
                )
            except (ValueError, IndexError):
                pass
            i += 1
        i += 1
        # --- H-bond 10-12 rows (skip) ---
        while i < len(lines) and lines[i].strip():
            i += 1
        i += 1
        # --- vdW equivalence lines ---
        while i < len(lines) and lines[i].strip():
            parts = lines[i].split()
            for alias in parts[1:]:
                self.equivalences[alias] = parts[0]
            i += 1
        i += 1
        # --- KINDNB label line ---
        if i < len(lines):
            i += 1
        # --- vdW parameters ---
        while i < len(lines) and lines[i].strip() and lines[i].strip().upper() != "END":
            parts = lines[i].split()
            try:
                rmin2 = float(parts[1])
                eps = abs(float(parts[2]))
                self.atom_types[parts[0]] = (rmin2 * _SIGMA_PER_RMIN2, eps)
            except (ValueError, IndexError):
                pass
            i += 1
        # resolve equivalences
        for alias, canon in self.equivalences.items():
            if alias not in self.atom_types and canon in self.atom_types:
                self.atom_types[alias] = self.atom_types[canon]

    def lookup_dihedral(self, key):
        """Exact, reversed, then CHARMM/AMBER-style (X, a2, a3, X)."""
        for k in (key, key[::-1],
                  ("X", key[1], key[2], "X"), ("X", key[2], key[1], "X")):
            if k in self.dihedral_types:
                return self.dihedral_types[k]
        return None

    def lookup_improper(self, key):
        """Improper (r0, r1, center, r2) with one- and two-X wildcard
        fallbacks, the tleap matching order."""
        c = key[2]
        rest = (key[0], key[1], key[3])
        cands = [key]
        from itertools import permutations as _perm

        for a, b in _perm(rest, 2):
            cands.append(("X", a, c, b))
        for r in rest:
            cands.append(("X", "X", c, r))
        for k in cands:
            if k in self.improper_periodic_types:
                return self.improper_periodic_types[k]
        return None


class AmberForcefield(_ForceFieldBase):
    """AMBER parameters from one or more sources: .prmtop (per-system
    tables), .dat (base sets like parm99/gaff, with X wildcards), and
    .frcmod overlays. Later files override earlier ones (the tleap
    loadAmberParams convention)."""

    def __init__(self, mol, prm):
        self.mol = mol
        sources = prm if isinstance(prm, (list, tuple)) else [prm]
        self.sets = [self._load_one(mol, p) for p in sources]
        self.prm = self.sets[-1]  # backward-compatible attribute

    @staticmethod
    def _load_one(mol, prm):
        from ..io.prmtop import Prmtop

        if isinstance(prm, (AmberParameterSet, AmberFrcmodParameterSet,
                            AmberParmDatParameterSet)):
            return prm
        if isinstance(prm, str) and prm.endswith(".prmtop"):
            top = getattr(mol, "prmtop", None)
            if top is None or getattr(top, "filename", None) not in (None, prm):
                top = Prmtop(prm)
            return AmberParameterSet(top)
        if isinstance(prm, str) and prm.endswith(".frcmod"):
            return AmberFrcmodParameterSet(prm)
        if isinstance(prm, str) and prm.endswith(".dat"):
            return AmberParmDatParameterSet(prm)
        raise ValueError(f"Unsupported AMBER parameter source: {prm}")

    # -- merged lookups: later files win ------------------------------
    def _table_get(self, table, key):
        for s in reversed(self.sets):
            t = getattr(s, table, None)
            if t and key in t:
                return t[key]
        return None

    def get_atom_types(self):
        return np.unique(self.mol.atomtype)

    def get_charge(self, at):
        idx = np.where(self.mol.atomtype == at)[0][0]
        return self.mol.charge[idx]

    def get_mass(self, at):
        for s in reversed(self.sets):
            m = getattr(s, "masses", None)
            if m and at in m:
                return m[at]
        idx = np.where(self.mol.atomtype == at)[0][0]
        return self.mol.masses[idx]

    def get_LJ(self, at):
        v = self._table_get("atom_types", at)
        if v is None:
            raise KeyError(f"No LJ parameters for atom type {at}")
        return v

    def get_bond(self, at1, at2):
        for key in ((at1, at2), (at2, at1)):
            v = self._table_get("bond_types", key)
            if v is not None:
                return v
        raise KeyError(f"No bond parameters for ({at1}, {at2})")

    def get_angle(self, at1, at2, at3):
        for key in ((at1, at2, at3), (at3, at2, at1)):
            v = self._table_get("angle_types", key)
            if v is not None:
                return v
        raise KeyError(f"No angle parameters for ({at1}, {at2}, {at3})")

    def _dihedral_terms(self, at1, at2, at3, at4):
        key = (at1, at2, at3, at4)
        for s in reversed(self.sets):
            lookup = getattr(s, "lookup_dihedral", None)
            if lookup is not None:
                terms = lookup(key)
                if terms:
                    return terms
            else:
                for k in (key, key[::-1]):
                    if k in s.dihedral_types:
                        return s.dihedral_types[k]
        raise RuntimeError(
            f"Could not find dihedral parameters for ({at1}, {at2}, {at3}, {at4})"
        )

    def get_dihedral(self, at1, at2, at3, at4):
        return [
            [k, phase, per] for (k, per, phase, _, _) in
            self._dihedral_terms(at1, at2, at3, at4)
        ]

    def get_14(self, at1, at2, at3, at4):
        terms = self._dihedral_terms(at1, at2, at3, at4)
        _, _, _, scee, scnb = terms[0]
        s1, e1 = self.get_LJ(at1)
        s4, e4 = self.get_LJ(at4)
        # AMBER has no distinct 1-4 LJ types: sigma_14 = sigma.
        return scnb, scee, s1, e1, s4, e4

    def get_improper(self, at1, at2, at3, at4):
        types = np.array((at1, at2, at3, at4))
        perms = [x for x in permutations((0, 1, 2, 3)) if x[2] == 2]
        for s in reversed(self.sets):
            lookup = getattr(s, "lookup_improper", None)
            for p in perms:
                key = tuple(types[list(p)])
                if key in getattr(s, "improper_types", {}):
                    k, phase = s.improper_types[key]
                    return k, phase, 0
                if lookup is not None:
                    v = lookup(key)
                    if v is not None:
                        k, per, phase = v
                        return k, phase, per
                elif key in s.improper_periodic_types:
                    k, per, phase = s.improper_periodic_types[key]
                    return k, phase, per
        raise RuntimeError(f"Could not find improper parameters for key {types}")
