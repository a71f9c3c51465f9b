"""GROMACS force-field ingestion: .top/.itp -> Parameters assembly.

New capability beyond the reference (torchmd reads YAML / CHARMM / AMBER
only): loads topologies in the GROMACS format -- the distribution vehicle
for OPLS-AA, the AMBER/CHARMM ports, GROMOS and Martini -- and assembles
them into the framework's native {idx, map, params} tables.

GROMACS differs structurally from the type-keyed CHARMM/AMBER model: a
.top resolves *per-instance* bonded parameters (inline on the interaction
line, or looked up from [bondtypes]/[angletypes]/[dihedraltypes] via
bonded types), carries per-atom charges, generates nonbonded exclusions
from the bond graph to depth `nrexcl` plus explicit [exclusions], and
lists 1-4 interactions explicitly in [pairs]. `GromacsForcefield`
therefore bypasses the nine type-keyed getters and assembles the
Parameters tables directly (the `assemble` hook), deduplicating parameter
rows by value so the result stays trainable.

Unit conversions (GROMACS -> framework):
    kJ/mol -> kcal/mol (x 1/4.184), nm -> Angstrom (x 10),
    V = k/2 (b-b0)^2   ->  k0 (r-r0)^2      with k0 = k/2 (+ unit factors)
    V = k/2 (th-th0)^2 ->  k0 (th-th0)^2    likewise
Dihedral functional forms:
    funct 1/4/9  k(1+cos(n phi - phi_s))    -> one periodic row per term
    funct 2      k/2 (xi-xi0)^2             -> harmonic improper (per=0)
    funct 3      Ryckaert-Bellemans         -> exact 5-term cosine
                 expansion (see `rb_to_periodic_rows`), including the
                 constant offset so absolute energies match GROMACS
    funct 5      Fourier series             -> 4 periodic rows
Combination rules ([defaults] comb-rule):
    2: Lorentz-Berthelot sigma/epsilon (the framework's native path)
    1: C6/C12 with geometric combination -> full (ntypes,ntypes) A/B tables
    3: sigma/epsilon, geometric sigma     -> full A/B tables
[nonbond_params] overrides (the NBFIX analogue) are baked into the A/B
tables. [settles] and [constraints] become zero-k bonds -- the
framework's idiom for rigid geometry (constraints.build_constraints /
build_settle pick them up; run with --constraints settle/hbonds).
"""

from __future__ import annotations

import os
from collections import defaultdict

import numpy as np

KJ2KCAL = 1.0 / 4.184
NM2ANG = 10.0
# harmonic spring constants: kJ/mol/nm^2 -> kcal/mol/A^2 including the 1/2
BOND_K = KJ2KCAL / (NM2ANG * NM2ANG) * 0.5
ANGLE_K = KJ2KCAL * 0.5
# C6 [kJ nm^6] -> B [kcal A^6]; C12 [kJ nm^12] -> A [kcal A^12]
C6_CONV = KJ2KCAL * NM2ANG**6
C12_CONV = KJ2KCAL * NM2ANG**12


# ----------------------------------------------------------------------
# Parse cache (Molecule construction and ForceField.create both read the
# same .top; the preprocessor walk is pure so cache by path+mtime)
# ----------------------------------------------------------------------

_CACHE: dict = {}


def load_gmx_top(path, include_dirs=(), defines=None):
    from ..io.gmxtop import build_molecule_arrays, parse_top

    # the port reads no environment: preprocessor defines come only from
    # the caller (the JAX package also reads TMD_GMX_DEFINES)
    defines = dict(defines or {})
    key = (
        os.path.abspath(path),
        tuple(include_dirs), tuple(sorted((defines or {}).items())),
    )
    hit = _CACHE.get(key)
    if hit is not None:
        mtimes, parsed = hit
        # invalidate when the .top OR any #include'd file changed
        if all(
            os.path.exists(f) and os.path.getmtime(f) == t
            for f, t in mtimes.items()
        ):
            return parsed
    top = parse_top(path, include_dirs=include_dirs, defines=defines)
    mtimes = {f: os.path.getmtime(f) for f in top.source_files}
    _CACHE[key] = (mtimes, (top, build_molecule_arrays(top)))
    if len(_CACHE) > 16:
        _CACHE.pop(next(iter(_CACHE)))
    return _CACHE[key][1]


# ----------------------------------------------------------------------
# Functional-form conversions
# ----------------------------------------------------------------------

def rb_to_periodic_rows(c, tol=1e-9):
    """Exact expansion of the Ryckaert-Bellemans potential
        V(phi) = sum_n C_n cos^n(psi),  psi = phi - 180 deg
    into the framework's periodic rows [k, phase, per] with
    E = sum k (1 + cos(per*phi - phase)).

    cos(psi) = -cos(phi), so V(phi) = sum C_n (-1)^n cos^n(phi); power
    reduction gives V = a0 + sum_{n>=1} a_n cos(n phi). Each a_n maps to a
    row [a_n, 0, n] (negative k is a valid energy row), contributing a_n
    to the constant; the residual constant c0 = a0 - sum a_n is realized
    exactly by the phase pair c0/2 (1+cos phi) + c0/2 (1+cos(phi-pi)).
    Inputs in kJ/mol; output rows in kcal/mol (radian phases)."""
    c = list(c) + [0.0] * (6 - len(c))
    C0, C1, C2, C3, C4, C5 = [v * KJ2KCAL for v in c[:6]]
    a0 = C0 + C2 / 2.0 + 3.0 * C4 / 8.0
    a = {
        1: -C1 - 3.0 * C3 / 4.0 - 10.0 * C5 / 16.0,
        2: C2 / 2.0 + C4 / 2.0,
        3: -C3 / 4.0 - 5.0 * C5 / 16.0,
        4: C4 / 8.0,
        5: -C5 / 16.0,
    }
    rows = [[an, 0.0, float(n)] for n, an in a.items() if abs(an) > tol]
    const = a0 - sum(r[0] for r in rows)
    if abs(const) > tol:
        rows.append([const / 2.0, 0.0, 1.0])
        rows.append([const / 2.0, np.pi, 1.0])
    if not rows:
        rows = [[0.0, 0.0, 1.0]]
    return rows


def fourier_to_periodic_rows(c):
    """GROMACS dihedral funct 5:
        V = 1/2 [C1(1+cos phi) + C2(1-cos 2phi) + C3(1+cos 3phi)
                 + C4(1-cos 4phi)]
    (1 - cos n phi) = (1 + cos(n phi - pi)). Inputs kJ/mol."""
    c = list(c) + [0.0] * (4 - len(c))
    rows = []
    for n, (coef, phase) in enumerate(
        zip(c[:4], (0.0, np.pi, 0.0, np.pi)), start=1
    ):
        if coef != 0.0:
            rows.append([0.5 * coef * KJ2KCAL, phase, float(n)])
    if not rows:
        rows = [[0.0, 0.0, 1.0]]
    return rows


def _sigeps_from_vw(V, W, comb_rule):
    """Per-type (sigma[A], eps[kcal]) from the atomtype V/W columns."""
    if comb_rule == 1:
        c6 = V * C6_CONV
        c12 = W * C12_CONV
        if c6 <= 0.0 or c12 <= 0.0:
            return 0.0, 0.0
        sigma = (c12 / c6) ** (1.0 / 6.0)
        eps = c6 * c6 / (4.0 * c12)
        return sigma, eps
    return V * NM2ANG, W * KJ2KCAL


def _pair_ab_from_vw(V, W, comb_rule):
    """Per-pair (A[kcal A^12], B[kcal A^6]) from explicit V/W values
    ([pairtypes]/[pairs]/[nonbond_params] lines)."""
    if comb_rule == 1:
        return W * C12_CONV, V * C6_CONV
    sig = V * NM2ANG
    eps = W * KJ2KCAL
    s6 = sig**6
    return 4.0 * eps * s6 * s6, 4.0 * eps * s6


# ----------------------------------------------------------------------
# Wildcard type-table lookup
# ----------------------------------------------------------------------

def _lookup2(table, b1, b2, funct):
    return table.get((b1, b2, funct)) or table.get((b2, b1, funct))


def _lookup3(table, b1, b2, b3, funct):
    return table.get((b1, b2, b3, funct)) or table.get((b3, b2, b1, funct))


def _lookup_dihedral(table, bt, funct):
    """GROMACS dihedraltypes matching: exact (either direction) first,
    then wildcard entries ('X' matches anything), preferring the match
    with the fewest wildcards."""
    key = (*bt, funct)
    hit = table.get(key) or table.get((*bt[::-1], funct))
    if hit is not None:
        return hit
    best, best_nx = None, 5
    for k, v in table.items():
        if k[4] != funct:
            continue
        pat = k[:4]
        nx = sum(1 for p in pat if p == "X")
        if nx == 0 or nx >= best_nx:
            continue
        for cand in (bt, bt[::-1]):
            if all(p == "X" or p == t for p, t in zip(pat, cand)):
                best, best_nx = v, nx
                break
    return best


# ----------------------------------------------------------------------
# The force field
# ----------------------------------------------------------------------

class GromacsForcefield:
    """Force field + direct Parameters assembly from a GROMACS .top.

    Construction does not need `mol` beyond API parity (the .top defines
    the full topology); `Parameters(ff, mol, terms)` detects the
    `assemble` hook and delegates to it."""

    def __init__(self, mol, prm, include_dirs=(), defines=None):
        self.mol = mol
        self.path = str(prm)
        self.top, self.arrays = load_gmx_top(
            self.path, include_dirs=include_dirs, defines=defines
        )
        self.comb_rule = self.top.defaults["comb_rule"]
        if self.top.defaults["nbfunc"] != 1:
            raise NotImplementedError(
                "Buckingham nonbonded ([defaults] nb-func 2) is not "
                "supported; only LJ (nb-func 1)"
            )

    # -- minimal type-keyed getters (API parity; assembly does not use
    # them, but get_LJ/get_charge/get_mass are well-defined per type) ----
    def get_atom_types(self):
        return np.unique(np.asarray(self.arrays["atomtype"]))

    def _attype(self, at):
        t = self.top.atomtypes.get(str(at))
        if t is None:
            raise ValueError(f"Unknown GROMACS atom type '{at}'")
        return t

    def get_LJ(self, at):
        return _sigeps_from_vw(
            self._attype(at)["V"], self._attype(at)["W"], self.comb_rule
        )

    def get_charge(self, at):
        return self._attype(at)["charge"]

    def get_mass(self, at):
        return self._attype(at)["mass"]

    def _btype(self, at):
        t = self.top.atomtypes.get(str(at))
        return t["btype"] if t is not None else str(at)

    def get_bond(self, at1, at2):
        prm = _lookup2(self.top.bondtypes, self._btype(at1),
                       self._btype(at2), 1)
        if prm is None:
            raise ValueError(f"No bondtype for {at1}-{at2}")
        return [prm[1] * BOND_K, prm[0] * NM2ANG]

    def get_angle(self, at1, at2, at3):
        prm = _lookup3(self.top.angletypes, self._btype(at1),
                       self._btype(at2), self._btype(at3), 1)
        if prm is None:
            prm = _lookup3(self.top.angletypes, self._btype(at1),
                           self._btype(at2), self._btype(at3), 5)
        if prm is None:
            raise ValueError(f"No angletype for {at1}-{at2}-{at3}")
        return [prm[1] * ANGLE_K, np.radians(prm[0])]

    def get_dihedral(self, at1, at2, at3, at4):
        bt = tuple(self._btype(a) for a in (at1, at2, at3, at4))
        for funct in (9, 1, 3, 5):
            hit = _lookup_dihedral(self.top.dihedraltypes, bt, funct)
            if hit is not None:
                return self._convert_dihedral_rows(funct, hit)
        raise ValueError(f"No dihedraltype for {'-'.join(map(str, bt))}")

    def get_improper(self, at1, at2, at3, at4):
        bt = tuple(self._btype(a) for a in (at1, at2, at3, at4))
        for funct in (4, 2):
            hit = _lookup_dihedral(self.top.dihedraltypes, bt, funct)
            if hit is not None:
                rows = self._convert_improper_rows(funct, hit)
                return rows[0]
        raise ValueError(f"No improper type for {'-'.join(map(str, bt))}")

    def get_14(self, at1, at2, at3, at4):
        # 1-4 interactions in GROMACS are explicit [pairs]; expose the
        # generated-pair view for the type-keyed API
        fudgeQQ = self.top.defaults["fudgeQQ"]
        s1, e1 = self.get_LJ(at1)
        s4, e4 = self.get_LJ(at4)
        fLJ = self.top.defaults["fudgeLJ"]
        return [1.0 / max(fLJ, 1e-12), 1.0 / max(fudgeQQ, 1e-12),
                s1, e1, s4, e4]

    # ------------------------------------------------------------------
    @staticmethod
    def _convert_dihedral_rows(funct, rows):
        out = []
        for prm in rows:
            if funct in (1, 9):
                phi_s, k = prm[0], prm[1]
                mult = prm[2] if len(prm) > 2 else 1
                out.append([k * KJ2KCAL, np.radians(phi_s), float(mult)])
            elif funct == 3:
                out.extend(rb_to_periodic_rows(prm))
            elif funct == 5:
                out.extend(fourier_to_periodic_rows(prm))
            else:
                raise NotImplementedError(
                    f"dihedral funct {funct} is not supported"
                )
        return out

    @staticmethod
    def _convert_improper_rows(funct, rows):
        out = []
        for prm in rows:
            if funct == 4:
                phi_s, k = prm[0], prm[1]
                mult = prm[2] if len(prm) > 2 else 1
                out.append([k * KJ2KCAL, np.radians(phi_s), float(mult)])
            elif funct == 2:
                xi0, k = prm[0], prm[1]
                out.append([k * ANGLE_K, np.radians(xi0), 0.0])
            else:
                raise NotImplementedError(
                    f"improper (dihedral) funct {funct} is not supported"
                )
        return out

    # ------------------------------------------------------------------
    # Direct assembly (Parameters delegates here)
    # ------------------------------------------------------------------

    def assemble(self, par, mol, terms):
        arr = self.arrays
        n = arr["natoms"]
        if mol.numAtoms != n:
            raise ValueError(
                f"Molecule has {mol.numAtoms} atoms but the GROMACS "
                f"topology defines {n}"
            )
        uqtypes, type_index = np.unique(arr["atomtype"], return_inverse=True)
        par.atomtypes = np.asarray(arr["atomtype"])
        par.mapped_atom_types = type_index.astype(np.int64)
        par.charges = arr["charge"].copy()
        par.masses = arr["masses"].reshape(-1, 1).copy()
        par.alpha = None
        par.thole = None

        if any(t in terms for t in ("lj", "repulsion", "repulsioncg")):
            self._assemble_nonbonded(par, uqtypes)
        if "bonds" in terms:
            self._assemble_bonds(par)
        if "angles" in terms:
            self._assemble_angles(par)
        if "dihedrals" in terms:
            self._assemble_dihedrals(par)
        if "impropers" in terms:
            self._assemble_impropers(par)
        if "1-4" in terms:
            self._assemble_pairs(par)

        par.explicit_exclusions = self._build_exclusions()
        par.gmx_vsites = arr["vsites_full"]
        par.gmx_defaults = dict(self.top.defaults)
        from ..vsites import build_vsite_groups

        par.vsites = build_vsite_groups(arr["vsites_full"])

        # [position_restraints] funct 1 (only present when its #ifdef --
        # typically POSRES -- is active): V = 1/2 sum_ax k_ax * d_ax^2;
        # store as (atom, kx, ky, kz) in kcal/mol/A^2 with the 1/2 folded
        # in. restraints.make_gromacs_posres builds the energy term.
        posres = []
        for atom, funct, prm in arr["posres_full"]:
            if funct != 1:
                raise NotImplementedError(
                    f"position_restraints funct {funct} is not supported "
                    "(flat-bottom funct 2: use restraints."
                    "FlatBottomRestraint directly)"
                )
            kx, ky, kz = (list(prm) + [0.0, 0.0, 0.0])[:3]
            posres.append((
                int(atom),
                kx * BOND_K, ky * BOND_K, kz * BOND_K,
            ))
        par.gmx_posres = posres

        # [distance_restraints]: (i, j, low, up1, up2, fac) Angstrom; the
        # force constant is fac x the .mdp disre-fc (restraints.
        # make_gromacs_distres). [dihedral_restraints]: (i,j,k,l, phi0,
        # dphi, k) radians / kcal/mol/rad^2.
        distres = []
        for (i, j), funct, prm in arr["distres_full"]:
            if funct != 1:
                raise NotImplementedError(
                    f"distance_restraints funct {funct}"
                )
            # columns after funct: label low up1 up2 fac  (type' column
            # folded into funct by the parser)
            label, low, up1, up2 = prm[0], prm[1], prm[2], prm[3]
            fac = prm[4] if len(prm) > 4 else 1.0
            distres.append((int(i), int(j), low * NM2ANG, up1 * NM2ANG,
                            up2 * NM2ANG, fac))
        par.gmx_distres = distres
        dihres = []
        for idx, funct, prm in arr["dihres_full"]:
            if funct != 1:
                raise NotImplementedError(
                    f"dihedral_restraints funct {funct}"
                )
            phi0, dphi = np.radians(prm[0]), np.radians(prm[1])
            kfac = (prm[2] if len(prm) > 2 else 0.0) * KJ2KCAL
            dihres.append((*(int(v) for v in idx), phi0, dphi, kfac))
        par.gmx_dihres = dihres

    # ------------------------------------------------------------------
    def _assemble_nonbonded(self, par, uqtypes):
        se = np.array(
            [self.get_LJ(t) for t in uqtypes], dtype=np.float64
        ).reshape(-1, 2)
        par.nonbonded_params = {
            "idx": None,
            "map": np.stack(
                [np.arange(len(par.mapped_atom_types)),
                 par.mapped_atom_types], axis=1
            ).astype(np.int64),
            "params": se,
        }
        par.nbfix = np.zeros((0, 4))

        overrides = self.top.nonbond_params
        if self.comb_rule == 2 and not overrides:
            return  # native Lorentz-Berthelot path; no tables needed

        T = len(uqtypes)
        A = np.zeros((T, T))
        B = np.zeros((T, T))
        raw = {str(t): self._attype(str(t)) for t in uqtypes}
        for i, ti in enumerate(uqtypes):
            for j, tj in enumerate(uqtypes):
                if self.comb_rule == 1:
                    c6 = np.sqrt(
                        raw[str(ti)]["V"] * raw[str(tj)]["V"]) * C6_CONV
                    c12 = np.sqrt(
                        raw[str(ti)]["W"] * raw[str(tj)]["W"]) * C12_CONV
                    A[i, j], B[i, j] = c12, c6
                else:
                    si, ei = se[i]
                    sj, ej = se[j]
                    if self.comb_rule == 3:
                        sig = np.sqrt(si * sj)
                    else:
                        sig = 0.5 * (si + sj)
                    eps = np.sqrt(ei * ej)
                    s6 = sig**6
                    A[i, j] = 4.0 * eps * s6 * s6
                    B[i, j] = 4.0 * eps * s6
        tmap = {str(t): i for i, t in enumerate(uqtypes)}
        for (t1, t2), (V, W) in overrides.items():
            if t1 in tmap and t2 in tmap:
                i, j = tmap[t1], tmap[t2]
                a, b = _pair_ab_from_vw(V, W, self.comb_rule)
                A[i, j] = A[j, i] = a
                B[i, j] = B[j, i] = b
        par.lj_ab_tables = (A, B)

    # ------------------------------------------------------------------
    def _dedup_rows(self):
        rows: list = []
        index: dict = {}

        def add(row):
            key = tuple(np.round(np.asarray(row, dtype=np.float64), 12))
            if key not in index:
                rows.append([float(v) for v in row])
                index[key] = len(rows) - 1
            return index[key]

        return rows, add

    def _assemble_bonds(self, par):
        arr = self.arrays
        entries = []  # (i, j, [k0, r0])
        g96 = []      # (i, j, [kq, b0]): GROMOS quartic (funct 2)
        for gi, funct, prm, mname in arr["bonds_full"]:
            if funct in (1, 2, 6):
                if prm is None:
                    bt = [self._btype(self.arrays["atomtype"][i])
                          for i in gi]
                    prm = _lookup2(self.top.bondtypes, bt[0], bt[1], funct)
                    if prm is None:
                        raise ValueError(
                            f"no bondtype for {bt[0]}-{bt[1]} "
                            f"(molecule {mname})"
                        )
                if funct == 2:
                    # GROMOS-96: V = 1/4 kb (r^2 - b0^2)^2, kb kJ/mol/nm^4
                    g96.append((gi[0], gi[1],
                                [0.25 * prm[1] * KJ2KCAL / NM2ANG**4,
                                 prm[0] * NM2ANG]))
                else:  # harmonic / harmonic-non-excluding
                    entries.append((gi[0], gi[1],
                                    [prm[1] * BOND_K, prm[0] * NM2ANG]))
            elif funct == 5:
                continue  # "connection": topology edge, no potential
            else:
                raise NotImplementedError(
                    f"bond funct {funct} (molecule {mname}) is not "
                    "supported"
                )
        # constraints and settles as zero-k bonds: the framework's rigid-
        # geometry idiom (constraints.build_constraints / build_settle
        # consume bond_params rows; k=0 adds no energy)
        for i, j, funct, b0 in arr["constraints_full"]:
            entries.append((i, j, [0.0, b0 * NM2ANG]))
        for o, h1, h2, doh, dhh in arr["settles_full"]:
            entries.append((o, h1, [0.0, doh * NM2ANG]))
            entries.append((o, h2, [0.0, doh * NM2ANG]))
            entries.append((h1, h2, [0.0, dhh * NM2ANG]))

        def pack(ent):
            rows, add = self._dedup_rows()
            seen = {}
            idx, mapping = [], []
            for i, j, prm in ent:
                key = (min(i, j), max(i, j))
                p = add(prm)
                if key in seen:
                    mapping.append([seen[key], p])
                    continue
                seen[key] = len(idx)
                mapping.append([len(idx), p])
                idx.append([key[0], key[1]])
            return {
                "idx": np.asarray(idx, np.int64),
                "map": np.asarray(mapping, np.int64),
                "params": np.asarray(rows, np.float64),
            }

        par.bond_params = pack(entries) if entries else None
        par.bond_g96_params = pack(g96) if g96 else None

    def _assemble_angles(self, par):
        arr = self.arrays
        rows, add = self._dedup_rows()
        ub_rows, ub_add = self._dedup_rows()
        g96_rows, g96_add = self._dedup_rows()
        idx, mapping = [], []
        ub_idx, ub_mapping = [], []
        g96_idx, g96_mapping = [], []
        for gi, funct, prm, mname in arr["angles_full"]:
            if prm is None:
                bt = [self._btype(arr["atomtype"][i]) for i in gi]
                prm = _lookup3(self.top.angletypes, bt[0], bt[1], bt[2],
                               funct)
                if prm is None:
                    raise ValueError(
                        f"no angletype for {'-'.join(bt)} funct {funct} "
                        f"(molecule {mname})"
                    )
            a = gi if gi[0] < gi[2] else gi[::-1]
            if funct == 2:
                # GROMOS-96 cosine-based: V = 1/2 k (cos th - cos th0)^2
                g96_mapping.append([
                    len(g96_idx),
                    g96_add([0.5 * prm[1] * KJ2KCAL,
                             np.cos(np.radians(prm[0]))]),
                ])
                g96_idx.append(list(a))
                continue
            if funct == 1:
                pass
            elif funct == 5:  # Urey-Bradley: angle + 1-3 spring
                if len(prm) >= 4 and prm[3] != 0.0:
                    ub_mapping.append([
                        len(ub_idx),
                        ub_add([prm[3] * BOND_K, prm[2] * NM2ANG]),
                    ])
                    ub_idx.append([gi[0], gi[2]])
            else:
                raise NotImplementedError(
                    f"angle funct {funct} (molecule {mname}) is not "
                    "supported"
                )
            mapping.append([len(idx),
                            add([prm[1] * ANGLE_K, np.radians(prm[0])])])
            idx.append(list(a))
        par.angle_params = (
            None if not idx else {
                "idx": np.asarray(idx, np.int64),
                "map": np.asarray(mapping, np.int64),
                "params": np.asarray(rows, np.float64),
            }
        )
        par.urey_bradley_params = (
            None if not ub_idx else {
                "idx": np.asarray(ub_idx, np.int64),
                "map": np.asarray(ub_mapping, np.int64),
                "params": np.asarray(ub_rows, np.float64),
            }
        )
        par.angle_g96_params = (
            None if not g96_idx else {
                "idx": np.asarray(g96_idx, np.int64),
                "map": np.asarray(g96_mapping, np.int64),
                "params": np.asarray(g96_rows, np.float64),
            }
        )

    def _gather_torsion_rows(self, gi, funct, prm, mname, improper):
        """Converted parameter rows for one [dihedrals] entry."""
        if prm is not None:  # inline parameters
            return (self._convert_improper_rows(funct, [prm]) if improper
                    else self._convert_dihedral_rows(funct, [prm]))
        bt = tuple(self._btype(self.arrays["atomtype"][i]) for i in gi)
        hit = _lookup_dihedral(self.top.dihedraltypes, bt, funct)
        if hit is None:
            raise ValueError(
                f"no dihedraltype for {'-'.join(bt)} funct {funct} "
                f"(molecule {mname})"
            )
        return (self._convert_improper_rows(funct, hit) if improper
                else self._convert_dihedral_rows(funct, hit))

    def _assemble_dihedrals(self, par):
        arr = self.arrays
        per_quad = defaultdict(list)  # canonical quad -> rows
        order = []
        for gi, funct, prm, mname in arr["dihedrals_full"]:
            if funct in (2, 4):
                continue
            quad = gi if gi[0] < gi[3] else gi[::-1]
            quad = tuple(quad)
            if quad not in per_quad:
                order.append(quad)
            per_quad[quad].extend(
                self._gather_torsion_rows(gi, funct, prm, mname, False)
            )
        if not order:
            par.dihedral_params = None
            return
        rows, add = self._dedup_rows()
        idx, mapping = [], []
        for quad in order:
            inst = len(idx)
            idx.append(list(quad))
            for row in per_quad[quad]:
                mapping.append([inst, add(row)])
        par.dihedral_params = {
            "idx": np.asarray(idx, np.int64),
            "map": np.asarray(mapping, np.int64),
            "params": np.asarray(rows, np.float64),
        }

    def _assemble_impropers(self, par):
        arr = self.arrays
        per_quad = defaultdict(list)
        order = []
        functs = set()
        for gi, funct, prm, mname in arr["dihedrals_full"]:
            if funct not in (2, 4):
                continue
            functs.add(funct)
            quad = tuple(gi)
            if quad not in per_quad:
                order.append(quad)
            per_quad[quad].extend(
                self._gather_torsion_rows(gi, funct, prm, mname, True)
            )
        if not order:
            par.improper_params = None
            return
        if functs == {2, 4}:
            raise NotImplementedError(
                "mixed harmonic (funct 2) and periodic (funct 4) impropers "
                "in one system: the evaluator branches globally on the "
                "improper style (reference semantics, forces.py:566-579)"
            )
        rows, add = self._dedup_rows()
        idx, mapping = [], []
        for quad in order:
            inst = len(idx)
            idx.append(list(quad))
            for row in per_quad[quad]:
                mapping.append([inst, add(row)])
        par.improper_params = {
            "idx": np.asarray(idx, np.int64),
            "map": np.asarray(mapping, np.int64),
            "params": np.asarray(rows, np.float64),
        }

    def _assemble_pairs(self, par):
        arr = self.arrays
        d = self.top.defaults
        fudgeLJ = d["fudgeLJ"]
        fudgeQQ = d["fudgeQQ"]
        scee = 1.0 / fudgeQQ if fudgeQQ > 0 else 1e12
        rows, add = self._dedup_rows()
        idx, mapping = [], []
        seen = set()
        se = None
        for gi, funct, prm, mname in arr["pairs_full"]:
            if funct != 1:
                raise NotImplementedError(
                    f"pairs funct {funct} (molecule {mname}) is not "
                    "supported"
                )
            i, j = (gi[0], gi[1]) if gi[0] < gi[1] else (gi[1], gi[0])
            if (i, j) in seen:
                continue
            seen.add((i, j))
            if prm is not None and len(prm) >= 2:
                a, b = _pair_ab_from_vw(prm[0], prm[1], self.comb_rule)
            else:
                t1 = str(arr["atomtype"][i])
                t2 = str(arr["atomtype"][j])
                b1, b2 = self._btype(t1), self._btype(t2)
                pt = _lookup2(self.top.pairtypes, b1, b2, 1)
                if pt is not None:
                    a, b = _pair_ab_from_vw(pt[0], pt[1], self.comb_rule)
                elif d["gen_pairs"]:
                    if self.comb_rule == 1:
                        # geometric combination acts on C6/C12 directly
                        ti = self._attype(t1)
                        tj = self._attype(t2)
                        b = np.sqrt(ti["V"] * tj["V"]) * C6_CONV * fudgeLJ
                        a = np.sqrt(ti["W"] * tj["W"]) * C12_CONV * fudgeLJ
                    else:
                        s1, e1 = self.get_LJ(t1)
                        s2, e2 = self.get_LJ(t2)
                        sig = (np.sqrt(s1 * s2) if self.comb_rule == 3
                               else 0.5 * (s1 + s2))
                        eps = np.sqrt(e1 * e2) * fudgeLJ
                        s6 = sig**6
                        a, b = 4.0 * eps * s6 * s6, 4.0 * eps * s6
                else:
                    raise ValueError(
                        f"no pairtype for {b1}-{b2} and gen-pairs is off "
                        f"(molecule {mname})"
                    )
            mapping.append([len(idx), add([a, b, 1.0, scee])])
            idx.append([i, j])
        par.nonbonded_14_params = {
            "idx": (np.asarray(idx, np.int64) if idx
                    else np.zeros((0, 2), np.int64)),
            "map": (np.asarray(mapping, np.int64) if mapping
                    else np.zeros((0, 2), np.int64)),
            "params": (np.asarray(rows, np.float64) if rows
                       else np.zeros((0, 4))),
        }

    # ------------------------------------------------------------------
    @staticmethod
    def _moltype_exclusions(mt):
        """Local (within-molecule) exclusion pairs for one moleculetype:
        bond-graph neighbours to depth nrexcl, explicit [exclusions],
        and every [pairs] entry (1-4 pairs are evaluated by the nb14
        table, never by the all-pairs term). Computed ONCE per type and
        replicated by atom offset per instance (exclusions never cross
        molecules in GROMACS)."""
        adj = defaultdict(set)
        for idx, funct, prm in mt.bonds:
            if funct == 6:
                # harmonic-potential "bonds" restrain without creating
                # chemical connectivity: no exclusions (GROMACS manual)
                continue
            adj[idx[0]].add(idx[1])
            adj[idx[1]].add(idx[0])
        for (i, j), funct, prm in mt.constraints:
            if funct == 1:  # funct 2 constraints do not generate exclusions
                adj[i].add(j)
                adj[j].add(i)
        for o, funct, doh, dhh in mt.settles:
            for a, b in ((o, o + 1), (o, o + 2), (o + 1, o + 2)):
                adj[a].add(b)
                adj[b].add(a)
        for vs in (mt.vsites2, mt.vsites3, mt.vsites4):
            for idx, funct, prm in vs:
                # site <-> first host edge: approximates GROMACS's "vsite
                # inherits its constructing atom's exclusions" (published
                # vsite topologies also carry explicit [exclusions],
                # which are authoritative below)
                adj[idx[0]].add(idx[1])
                adj[idx[1]].add(idx[0])

        pairs = set()
        depth = int(mt.nrexcl)
        for i in range(len(mt.atoms)):
            if depth <= 0:
                break
            frontier = {i}
            visited = {i}
            for _ in range(depth):
                nxt = set()
                for a in frontier:
                    nxt |= adj[a]
                nxt -= visited
                for j in nxt:
                    if i < j:
                        pairs.add((i, j))
                visited |= nxt
                frontier = nxt
        for i, js in mt.exclusions:
            for j in js:
                pairs.add((min(i, j), max(i, j)))
        for idx, funct, prm in mt.pairs:
            pairs.add((min(idx), max(idx)))
        return sorted(pairs)

    def _build_exclusions(self):
        """Whole-system exclusion list: per-moleculetype local pairs
        (cached) shifted by each instance's atom offset."""
        local: dict = {}
        pairs = []
        off = 0
        for mname, count in self.top.molecules:
            mt = self.top.moleculetypes[mname]
            if mname not in local:
                local[mname] = self._moltype_exclusions(mt)
            nat = len(mt.atoms)
            lp = local[mname]
            for _ in range(count):
                pairs.extend((i + off, j + off) for i, j in lp)
                off += nat
        return pairs
