"""CHARMM parameter (.prm / .par) and topology (.rtf) reader.

The port's own copy of `torchmd_tpu.forcefields.ff_charmm`; it imports nothing of the JAX
package.

Self-contained replacement for `parmed.charmm.CharmmParameterSet` as used by
the reference (torchmd/forcefields/ff_parmed.py:28, tests/test_torchmd.py:384).
Parses BONDS/ANGLES/DIHEDRALS/IMPROPER/NONBONDED sections (plus ATOMS/MASS
from .prm or .rtf for atom masses) and exposes the common force-field getter
interface.

Conventions:
  - epsilon stored positive (CHARMM files carry it negative; only |eps| is
    physical -- all downstream math uses sqrt(eps_i * eps_j)).
  - sigma derived from Rmin/2 columns: sigma = 2 * (Rmin/2) * 2**(-1/6).
  - CHARMM dihedrals have scee = scnb = 1.0 (e14fac 1.0 convention).
  - Dihedral lookup: exact, reversed, then CHARMM-style wildcard
    (X, a2, a3, X) forms.
  - Improper lookup: all permutations with the center fixed at position 2,
    matching the reference's lookup loop (ff_parmed.py:116-129).
"""

from __future__ import annotations

from itertools import permutations
from math import radians

import numpy as np

from .forcefield import _ForceFieldBase

_SIGMA_PER_RMIN2 = 2.0 ** (5.0 / 6.0)  # sigma = rmin2 * 2 / 2^(1/6)

_SECTIONS = (
    "ATOMS", "BONDS", "ANGLES", "DIHEDRALS", "IMPROPER", "IMPROPERS",
    "NONBONDED", "CMAP", "NBFIX", "HBOND", "THOLE", "NBTHOLE", "END",
)


class CharmmParameterSet:
    """Parsed CHARMM parameter tables keyed by atom-type tuples."""

    def __init__(self, *filenames):
        self.masses: dict[str, float] = {}
        self.bond_types: dict[tuple, tuple] = {}
        self.angle_types: dict[tuple, tuple] = {}
        self.urey_bradley_types: dict[tuple, tuple] = {}
        self.dihedral_types: dict[tuple, list] = {}
        self.improper_types: dict[tuple, tuple] = {}
        self.improper_periodic_types: dict[tuple, tuple] = {}
        self.nonbonded_types: dict[str, tuple] = {}  # (eps, rmin2, eps14, rmin14_2)
        self.nbfix_types: dict[tuple, tuple] = {}
        # Drude-2013 pair-specific Thole screening between NONBONDED
        # oscillator pairs (NBTHOLE section, toppar_drude convention:
        # "type_i type_j a"); the global bonded-pair Thole comes from
        # the RTF THOLE atom attributes instead
        self.nbthole_types: dict[tuple, float] = {}
        self.cmap_types: dict[tuple, np.ndarray] = {}  # 8-type key -> (n, n)
        # CHARMM Drude-2013 polarizable-FF content from RTF residue
        # definitions: per (RESI, atom name) ALPHA/THOLE attributes and
        # LONEPAIR virtual-site records (lonepairs: {resi: [dict, ...]})
        self.rtf_atoms: dict[tuple, dict] = {}
        self.rtf_lonepairs: dict[str, list] = {}
        self._resi = None
        self._cmap_key = None
        self._cmap_n = 0
        self._cmap_vals: list[float] = []
        for fn in filenames:
            self._parse(fn)
            self._cmap_flush()

    def _cmap_flush(self):
        """Store a completed CMAP grid (phi-major: vals[i*n+j] = E(phi_i,
        psi_j), both axes from -180 deg in 360/n steps)."""
        if self._cmap_key is not None and len(self._cmap_vals) == self._cmap_n**2:
            grid = np.asarray(self._cmap_vals, dtype=np.float64).reshape(
                self._cmap_n, self._cmap_n
            )
            self.cmap_types[self._cmap_key] = grid
        self._cmap_key, self._cmap_n, self._cmap_vals = None, 0, []

    # ------------------------------------------------------------------
    def _parse(self, filename: str):
        with open(filename, "r", encoding="utf-8", errors="replace") as f:
            raw_lines = f.readlines()

        # Join continuation lines ending with '-'
        lines: list[str] = []
        pending = ""
        for raw in raw_lines:
            line = raw.split("!")[0].rstrip()
            if pending:
                line = pending + " " + line.strip()
                pending = ""
            if line.endswith("-"):
                pending = line[:-1]
                continue
            lines.append(line)

        section = None
        for line in lines:
            ls = line.strip()
            if not ls or ls.startswith("*"):
                continue
            up = ls.upper()
            first = up.split()[0]
            if first in _SECTIONS or first.startswith("NONBONDED"):
                section = "IMPROPER" if first == "IMPROPERS" else first
                if section == "END":
                    section = None
                continue
            if first == "MASS":
                # RTF/PRM atom definition: MASS idx TYPE mass [element]
                parts = ls.split()
                if len(parts) >= 4:
                    self.masses[parts[2]] = float(parts[3])
                continue
            if first in ("RESI", "PRES"):
                self._resi = ls.split()[1]
                continue
            if first == "ATOM" and self._resi is not None:
                # RTF residue atom: ATOM name type charge
                #                   [ALPHA a] [THOLE t] (Drude-2013)
                parts = ls.split()
                if len(parts) >= 4:
                    rec = {"type": parts[2], "charge": float(parts[3]),
                           "alpha": 0.0, "thole": None}
                    toks = [p.upper() for p in parts]
                    for kw in ("ALPHA", "THOLE"):
                        if kw in toks:
                            i = toks.index(kw)
                            if i + 1 < len(parts):
                                rec[kw.lower()] = float(parts[i + 1])
                    # Drude convention stores alpha negative; magnitude
                    # is the polarizability in A^3
                    rec["alpha"] = abs(rec["alpha"])
                    self.rtf_atoms[(self._resi, parts[1])] = rec
                continue
            if first == "LONEPAIR" and self._resi is not None:
                # LONEPAIR bisector|relative|colinear LP h1 h2 [h3]
                #          distance d [angle a] [dihe phi]  (case-insens.)
                parts = ls.split()
                toks = [p.upper() for p in parts]
                kind = toks[1]
                names = []
                vals = {"distance": 0.0, "angle": 0.0, "dihe": 0.0}
                i = 2
                while i < len(parts):
                    t = toks[i]
                    matched = False
                    for kw in vals:
                        if t.startswith(kw[:4].upper()):
                            vals[kw] = float(parts[i + 1])
                            i += 2
                            matched = True
                            break
                    if not matched:
                        names.append(parts[i])
                        i += 1
                self.rtf_lonepairs.setdefault(self._resi, []).append({
                    "kind": kind.lower(), "site": names[0],
                    "hosts": names[1:], **vals,
                })
                continue
            if first in ("AUTO", "DECL", "DEFA", "GROUP", "ATOM",
                         "BOND", "DOUBLE", "ANGL", "DIHE", "IMPR",
                         "DONOR", "ACCEPTOR", "IC", "PATCH", "CUTNB",
                         "ANISOTROPY", "LONEPAIR"):
                # remaining RTF residue-definition content: not parameters
                continue

            parts = ls.split()
            try:
                if section == "BONDS" and len(parts) >= 4:
                    key = (parts[0], parts[1])
                    val = (float(parts[2]), float(parts[3]))
                    self.bond_types[key] = val
                    self.bond_types[key[::-1]] = val
                elif section == "ANGLES" and len(parts) >= 5:
                    key = (parts[0], parts[1], parts[2])
                    val = (float(parts[3]), float(parts[4]))
                    self.angle_types[key] = val
                    self.angle_types[key[::-1]] = val
                    if len(parts) >= 7:
                        ub = (float(parts[5]), float(parts[6]))
                        self.urey_bradley_types[key] = ub
                        self.urey_bradley_types[key[::-1]] = ub
                elif section == "DIHEDRALS" and len(parts) >= 7:
                    key = (parts[0], parts[1], parts[2], parts[3])
                    term = (float(parts[4]), int(float(parts[5])), float(parts[6]))
                    if key[::-1] in self.dihedral_types and key not in self.dihedral_types:
                        key = key[::-1]
                    lst = self.dihedral_types.setdefault(key, [])
                    self.dihedral_types[key[::-1]] = lst
                    if term not in lst:
                        lst.append(term)
                elif section == "IMPROPER" and len(parts) >= 7:
                    key = (parts[0], parts[1], parts[2], parts[3])
                    k = float(parts[4])
                    per = int(float(parts[5]))
                    phase = float(parts[6])
                    if per == 0:
                        self.improper_types[key] = (k, phase)
                    else:
                        self.improper_periodic_types[key] = (k, per, phase)
                elif section == "NONBONDED" and len(parts) >= 4:
                    at = parts[0]
                    eps = abs(float(parts[2]))
                    rmin2 = float(parts[3])
                    if len(parts) >= 7:
                        eps14 = abs(float(parts[5]))
                        rmin14_2 = float(parts[6])
                    else:
                        eps14, rmin14_2 = eps, rmin2
                    self.nonbonded_types[at] = (eps, rmin2, eps14, rmin14_2)
                elif section == "CMAP":
                    # Header: 8 atom types + grid resolution; body: floats
                    # (5 per line in the CHARMM36 files), n*n per map.
                    def _numeric(tok):
                        try:
                            float(tok)
                            return True
                        except ValueError:
                            return False

                    if len(parts) == 9 and not _numeric(parts[0]):
                        self._cmap_flush()
                        self._cmap_key = tuple(parts[:8])
                        self._cmap_n = int(float(parts[8]))
                    elif self._cmap_key is not None:
                        self._cmap_vals.extend(float(x) for x in parts)
                elif section == "NBFIX" and len(parts) >= 4:
                    key = (parts[0], parts[1])
                    val = (abs(float(parts[2])), float(parts[3]))
                    self.nbfix_types[key] = val
                    self.nbfix_types[key[::-1]] = val
                elif section in ("NBTHOLE", "THOLE") and len(parts) >= 3:
                    key = (parts[0], parts[1])
                    a = float(parts[2])
                    self.nbthole_types[key] = a
                    self.nbthole_types[key[::-1]] = a
            except (ValueError, IndexError):
                continue


class CharmmForcefield(_ForceFieldBase):
    def __init__(self, mol, prm):
        self.mol = mol
        if isinstance(prm, CharmmParameterSet):
            self.prm = prm
        else:
            files = prm if isinstance(prm, (list, tuple)) else [prm]
            self.prm = CharmmParameterSet(*files)

    def get_atom_types(self):
        return np.unique(list(self.prm.nonbonded_types.keys()))

    def get_charge(self, at):
        idx = np.where(self.mol.atomtype == at)[0][0]
        return self.mol.charge[idx]

    def get_mass(self, at):
        if at in self.prm.masses:
            return self.prm.masses[at]
        idx = np.where(self.mol.atomtype == at)[0][0]
        return self.mol.masses[idx]

    def get_LJ(self, at):
        eps, rmin2, _, _ = self.prm.nonbonded_types[at]
        return rmin2 * _SIGMA_PER_RMIN2, eps

    def get_bond(self, at1, at2):
        return self.prm.bond_types[(at1, at2)]

    def get_angle(self, at1, at2, at3):
        k, theta0 = self.prm.angle_types[(at1, at2, at3)]
        return k, radians(theta0)

    def _dihedral_terms(self, at1, at2, at3, at4):
        cand = [
            (at1, at2, at3, at4),
            (at4, at3, at2, at1),
            ("X", at2, at3, "X"),
            ("X", at3, at2, "X"),
        ]
        for key in cand:
            if key in self.prm.dihedral_types:
                return self.prm.dihedral_types[key]
        raise RuntimeError(
            f"Could not find dihedral parameters for ({at1}, {at2}, {at3}, {at4})"
        )

    def get_dihedral(self, at1, at2, at3, at4):
        return [
            [k, radians(phase), per]
            for (k, per, phase) in self._dihedral_terms(at1, at2, at3, at4)
        ]

    def get_14(self, at1, at2, at3, at4):
        self._dihedral_terms(at1, at2, at3, at4)  # existence check
        e1, r1, e14_1, r14_1 = self.prm.nonbonded_types[at1]
        e4, r4, e14_4, r14_4 = self.prm.nonbonded_types[at4]
        return (
            1.0,  # scnb: CHARMM uses explicit 1-4 LJ types instead of scaling
            1.0,  # scee: e14fac 1.0
            r14_1 * _SIGMA_PER_RMIN2,
            e14_1,
            r14_4 * _SIGMA_PER_RMIN2,
            e14_4,
        )

    def get_urey_bradley(self, at1, at2, at3):
        """(Kub, S0) for the 1-3 spring of a CHARMM angle type, or None
        when the angle has no UB columns."""
        for key in ((at1, at2, at3), (at3, at2, at1)):
            if key in self.prm.urey_bradley_types:
                return self.prm.urey_bradley_types[key]
        return None

    def get_nbfix(self):
        """Pair-specific LJ overrides {(t1, t2): (eps, rmin_full)} from the
        NBFIX section (capability the reference lacks: its 2ions/3ions
        tests loosen tolerances with 'I don't have nbfix',
        tests/test_torchmd.py:325-326)."""
        return dict(self.prm.nbfix_types)

    def get_cmap(self, *types8):
        """(n, n) CMAP grid (kcal/mol) for an 8-type cross-term key, or
        None when the parameter set carries no map for it. Tries the key
        as given, then with each dihedral reversed (the equivalent
        torsion orientation)."""
        key = tuple(types8)
        rev = tuple(reversed(key[:4])) + tuple(reversed(key[4:]))
        for k in (key, rev):
            if k in self.prm.cmap_types:
                return self.prm.cmap_types[k]
        return None

    def get_improper(self, at1, at2, at3, at4):
        types = np.array((at1, at2, at3, at4))
        perms = [x for x in permutations((0, 1, 2, 3)) if x[2] == 2]
        for p in perms:
            key = tuple(types[list(p)])
            if key in self.prm.improper_types:
                k, phase = self.prm.improper_types[key]
                return k, radians(phase), 0
            if key in self.prm.improper_periodic_types:
                k, per, phase = self.prm.improper_periodic_types[key]
                return k, radians(phase), per
        raise RuntimeError(f"Could not find improper parameters for key {types}")
