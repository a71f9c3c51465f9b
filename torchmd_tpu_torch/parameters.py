"""Force-field parameter assembly: per-term {idx, map, params} tables.

Re-implements the reference data model (torchmd/parameters.py:109-294) on
numpy; `potentials.make_ffparams` freezes it into tensors (`FFParams`) for
the compute path. The dedup-by-atom-type structure is what makes force-field
parameters trainable: `params` holds one row per unique type combination,
`map` is the (instance -> param row) indirection (one-to-many for
multi-term dihedrals).

Canonical orderings (identical to the reference so energies match exactly):
  - bonds: each pair sorted, rows unique (parameters.py:160)
  - angles: flipped so idx0 < idx2, rows unique (parameters.py:177-178)
  - dihedrals: flipped so idx0 < idx3, rows unique (parameters.py:200-201)
  - impropers: rows unique, order within row preserved (parameters.py:224)
  - 1-4 pairs: dihedral (0,3) ends not already excluded by bonds/angles,
    deduplicated by end pair (parameters.py:253-294); A/B from
    Lorentz-Berthelot on sigma14/epsilon14.
"""

from __future__ import annotations

from collections import defaultdict
from math import sqrt

import numpy as np


class Parameters:
    """Host-side (numpy, float64) parameter assembly.

    Mirrors the reference `Parameters` public surface: per-term dicts of
    {idx, map, params}, plus charges/masses/mapped_atom_types and the
    A/B LJ tables. `precision`/`device` are accepted for API parity; the
    JAX compute path consumes `FFParams` built via `to_ffparams()`.
    """

    def __init__(self, ff, mol, terms=None, precision=None, device=None):
        self.nonbonded_params = None
        self.bond_params = None
        self.charges = None
        self.masses = None
        self.mapped_atom_types = None
        self.angle_params = None
        self.dihedral_params = None
        self.nonbonded_14_params = None
        self.improper_params = None
        self.A = None
        self.B = None
        self.natoms = mol.numAtoms
        self.precision = precision
        self.device = device
        self.nbfix = np.zeros((0, 4))  # rows: [type_i, type_j, eps, rmin]
        self.urey_bradley_params = None
        self.cmap_params = None
        self.bond_g96_params = None   # GROMOS quartic bonds (funct 2)
        self.angle_g96_params = None  # GROMOS cosine angles (funct 2)

        if terms is None:
            terms = ("bonds", "angles", "dihedrals", "impropers", "1-4", "lj")
        terms = [t.lower() for t in terms]
        if hasattr(ff, "assemble"):
            # Direct-assembly force fields (GROMACS: per-instance bonded
            # parameters, explicit exclusions/pairs) bypass the nine
            # type-keyed getters and fill the tables themselves.
            ff.assemble(self, mol, terms)
        else:
            self.build_parameters(ff, mol, terms)

    # ------------------------------------------------------------------
    def get_exclusions(self, types=("bonds", "angles", "1-4"), fullarray=False):
        explicit = getattr(self, "explicit_exclusions", None)
        if explicit is not None:
            # Topologies that generate their own exclusion list (GROMACS
            # nrexcl + [exclusions] + [pairs]) are authoritative: the
            # bonded-class `types` selection does not apply.
            exclusions = [list(p) for p in explicit]
            if fullarray:
                fullmat = np.full((self.natoms, self.natoms), False, dtype=bool)
                if len(exclusions):
                    exc = np.array(exclusions)
                    fullmat[exc[:, 0], exc[:, 1]] = True
                    fullmat[exc[:, 1], exc[:, 0]] = True
                return fullmat
            return exclusions
        exclusions = []
        if self.bond_params is not None and "bonds" in types:
            exclusions += self.bond_params["idx"].tolist()
        if self.angle_params is not None and "angles" in types:
            exclusions += self.angle_params["idx"][:, [0, 2]].tolist()
        if self.dihedral_params is not None and "1-4" in types:
            exclusions += self.dihedral_params["idx"][:, [0, 3]].tolist()
        if fullarray:
            fullmat = np.full((self.natoms, self.natoms), False, dtype=bool)
            if len(exclusions):
                exc = np.array(exclusions)
                fullmat[exc[:, 0], exc[:, 1]] = True
                fullmat[exc[:, 1], exc[:, 0]] = True
            return fullmat
        return exclusions

    # ------------------------------------------------------------------
    def build_parameters(self, ff, mol, terms):
        uqatomtypes, indexes = np.unique(mol.atomtype, return_inverse=True)
        self.atomtypes = np.asarray(mol.atomtype)
        self.mapped_atom_types = indexes.astype(np.int64)
        self.charges = np.asarray(mol.charge, dtype=np.float64)

        # optional per-atom polarizabilities (Drude force fields): the
        # YAML schema's `polarizabilities: {TYPE: {alpha, thole}}` section
        self.alpha = None
        self.thole = None
        if hasattr(ff, "get_polarizability"):
            al = np.zeros(self.natoms)
            th = np.full(self.natoms, np.nan)
            for i, at in enumerate(mol.atomtype):
                a, t = ff.get_polarizability(at)
                al[i] = a
                if t is not None:
                    th[i] = t
            if np.any(al > 0):
                self.alpha = al
                self.thole = th

        mm = (
            np.asarray(mol.masses, dtype=np.float64)
            if mol.masses is not None
            else np.zeros(0)
        )
        if mm.size and np.any(mm != 0):
            self.masses = mm.reshape(-1, 1)
        else:
            # topology carries no masses (e.g. coarse-grained PSFs with
            # zero mass columns): take them from the force field
            self.masses = np.array(
                [ff.get_mass(at) for at in mol.atomtype], dtype=np.float64
            ).reshape(-1, 1)

        if any(t in terms for t in ("lj", "repulsion", "repulsioncg")):
            self.nonbonded_params = self._make_nonbonded(mol, ff, uqatomtypes)
            self.nbfix = self._make_nbfix(ff, uqatomtypes)
        if "bonds" in terms and len(mol.bonds):
            self.bond_params = self._make_bonds(mol, ff)
        if "angles" in terms and len(mol.angles):
            self.angle_params = self._make_angles(mol, ff)
        if "urey-bradley" in terms and len(mol.angles):
            self.urey_bradley_params = self._make_urey_bradley(mol, ff)
        if "dihedrals" in terms and len(mol.dihedrals):
            self.dihedral_params = self._make_dihedrals(mol, ff)
        if "impropers" in terms and len(mol.impropers):
            self.improper_params = self._make_impropers(mol, ff)
        if "1-4" in terms and len(mol.dihedrals):
            self.nonbonded_14_params = self._make_14(mol, ff)
        if "cmap" in terms and len(getattr(mol, "crossterms", [])):
            self.cmap_params = self._make_cmap(mol, ff)

    # ------------------------------------------------------------------
    def _make_nonbonded(self, mol, ff, uqatomtypes):
        params = np.array([ff.get_LJ(at) for at in uqatomtypes], dtype=np.float64)
        mapping = np.stack(
            [np.arange(mol.numAtoms), self.mapped_atom_types], axis=1
        ).astype(np.int64)
        return {"idx": None, "map": mapping, "params": params}

    def _make_nbfix(self, ff, uqatomtypes):
        """Pair-specific LJ overrides as [type_i, type_j, eps, rmin_full]
        rows over the unique-type index space (CHARMM NBFIX)."""
        getter = getattr(ff, "get_nbfix", None)
        if getter is None:
            return np.zeros((0, 4))
        tmap = {t: i for i, t in enumerate(uqatomtypes)}
        rows = []
        seen = set()
        for (t1, t2), (eps, rmin) in getter().items():
            if t1 in tmap and t2 in tmap:
                i, j = sorted((tmap[t1], tmap[t2]))
                if (i, j) not in seen:
                    seen.add((i, j))
                    rows.append([i, j, abs(eps), rmin])
        return np.asarray(rows, dtype=np.float64).reshape(-1, 4)

    def _make_bonds(self, mol, ff):
        uqbonds = np.unique([sorted(bb) for bb in mol.bonds], axis=0)
        param_idx: dict = {}
        rows, mapping = [], []
        for i, bb in enumerate(uqbonds):
            at_t = tuple(np.asarray(mol.atomtype)[bb])
            if at_t not in param_idx:
                rows.append(ff.get_bond(*at_t))
                param_idx[at_t] = len(rows) - 1
            mapping.append([i, param_idx[at_t]])
        return {
            "idx": uqbonds.astype(np.int64),
            "map": np.array(mapping, dtype=np.int64),
            "params": np.array(rows, dtype=np.float64),
        }

    def _make_angles(self, mol, ff):
        uqangles = np.unique(
            [ang if ang[0] < ang[2] else ang[::-1] for ang in mol.angles], axis=0
        )
        param_idx: dict = {}
        rows, mapping = [], []
        at = np.asarray(mol.atomtype)
        for i, aa in enumerate(uqangles):
            at_t = tuple(at[aa])
            if at_t not in param_idx:
                rows.append(ff.get_angle(*at_t))
                param_idx[at_t] = len(rows) - 1
            mapping.append([i, param_idx[at_t]])
        return {
            "idx": uqangles.astype(np.int64),
            "map": np.array(mapping, dtype=np.int64),
            "params": np.array(rows, dtype=np.float64),
        }

    def _make_dihedrals(self, mol, ff):
        uqdihedrals = np.unique(
            [d if d[0] < d[3] else d[::-1] for d in mol.dihedrals], axis=0
        )
        at = np.asarray(mol.atomtype)
        param_idx = defaultdict(list)
        rows, mapping = [], []
        for i, types in enumerate(at[uqdihedrals]):
            key = tuple(types)
            if key not in param_idx:
                for term in ff.get_dihedral(*types):
                    rows.append(term)
                    param_idx[key].append(len(rows) - 1)
            for p in param_idx[key]:
                mapping.append([i, p])
        return {
            "idx": uqdihedrals.astype(np.int64),
            "map": np.array(mapping, dtype=np.int64),
            "params": np.array(rows, dtype=np.float64),
        }

    def _make_urey_bradley(self, mol, ff):
        """CHARMM Urey-Bradley 1-3 springs: harmonic in the terminal-atom
        distance of angles whose type triple carries UB parameters
        (capability the reference lacks)."""
        getter = getattr(ff, "get_urey_bradley", None)
        if getter is None:
            return None
        uqangles = np.unique(
            [ang if ang[0] < ang[2] else ang[::-1] for ang in mol.angles], axis=0
        )
        at = np.asarray(mol.atomtype)
        param_idx: dict = {}
        rows, mapping, idx = [], [], []
        for aa in uqangles:
            at_t = tuple(at[aa])
            p = getter(*at_t)
            if p is None:
                continue
            if at_t not in param_idx:
                rows.append(p)
                param_idx[at_t] = len(rows) - 1
            mapping.append([len(idx), param_idx[at_t]])
            idx.append([aa[0], aa[2]])
        if not rows:
            return None
        return {
            "idx": np.asarray(idx, dtype=np.int64),
            "map": np.asarray(mapping, dtype=np.int64),
            "params": np.asarray(rows, dtype=np.float64),
        }

    def _make_impropers(self, mol, ff):
        uqimpropers = np.unique(mol.impropers, axis=0)
        uqbonds = np.unique([sorted(bb) for bb in mol.bonds], axis=0)
        at = np.asarray(mol.atomtype)
        neighbors = _bond_neighbors(uqbonds)

        param_idx: dict = {}
        rows, mapping = [], []
        for i, impr in enumerate(uqimpropers):
            types = at[impr]
            try:
                params = ff.get_improper(*types)
            except Exception:
                center = _detect_improper_center(impr, neighbors)
                notcenter = sorted(np.setdiff1d(impr, [center]))
                order = [notcenter[0], notcenter[1], center, notcenter[2]]
                types = at[order]
                params = ff.get_improper(*types)
            key = tuple(types)
            if key not in param_idx:
                rows.append(params)
                param_idx[key] = len(rows) - 1
            mapping.append([i, param_idx[key]])
        return {
            "idx": uqimpropers.astype(np.int64),
            "map": np.array(mapping, dtype=np.int64),
            "params": np.array(rows, dtype=np.float64),
        }

    def _make_cmap(self, mol, ff):
        """CHARMM36 CMAP cross-terms: one {idx, map, tables} entry per PSF
        NCRTERM row (8 atoms = two dihedrals), deduplicated by the 8-type
        key. `tables` holds one (n, n) grid per unique map (capability the
        reference lacks)."""
        getter = getattr(ff, "get_cmap", None)
        if getter is None:
            return None
        at = np.asarray(mol.atomtype)
        crossterms = np.asarray(mol.crossterms, dtype=np.int64)
        param_idx: dict = {}
        tables, mapping, idx = [], [], []
        for ct in crossterms:
            key = tuple(at[ct])
            if key not in param_idx:
                grid = getter(*key)
                if grid is None:
                    raise RuntimeError(
                        f"Could not find CMAP parameters for types {key}"
                    )
                tables.append(np.asarray(grid, dtype=np.float64))
                param_idx[key] = len(tables) - 1
            mapping.append([len(idx), param_idx[key]])
            idx.append(ct)
        if not tables:
            return None
        return {
            "idx": np.asarray(idx, dtype=np.int64),
            "map": np.asarray(mapping, dtype=np.int64),
            "tables": tables,
        }

    def _make_14(self, mol, ff):
        uqdihedrals = np.unique(
            [d if d[0] < d[3] else d[::-1] for d in mol.dihedrals], axis=0
        )
        # the end pairs that are bonds or angles, by a sorted key a * N + b
        # of each unordered pair (the dense (N, N) matrix is 10.6 GB at
        # 103,200 atoms)
        n = np.int64(self.natoms)
        excl = np.asarray(self.get_exclusions(types=("bonds", "angles")),
                          dtype=np.int64).reshape(-1, 2)
        ekeys = np.unique(excl.min(1) * n + excl.max(1))
        ends = uqdihedrals[:, [0, 3]].astype(np.int64)
        keep = ~np.isin(ends.min(1) * n + ends.max(1), ekeys)
        dih14 = uqdihedrals[keep, :]
        out = {"idx": [], "map": [], "params": []}
        if not len(dih14):
            return out
        uq14idx = np.unique(dih14[:, [0, 3]], axis=0, return_index=True)[1]
        dih14 = dih14[uq14idx]
        out["idx"] = dih14[:, [0, 3]].astype(np.int64)

        at = np.asarray(mol.atomtype)
        param_idx: dict = {}
        rows, mapping = [], []
        for i, types in enumerate(at[dih14]):
            scnb, scee, s14_1, e14_1, s14_4, e14_4 = ff.get_14(*types)
            # Lorentz-Berthelot on the 1-4 LJ parameters
            sig = 0.5 * (s14_1 + s14_4)
            eps = sqrt(e14_1 * e14_4)
            s6 = sig**6
            rows_key = tuple(types)
            if tuple(types[::-1]) in param_idx:
                rows_key = tuple(types[::-1])
            if rows_key not in param_idx:
                rows.append([eps * 4 * s6 * s6, eps * 4 * s6, scnb, scee])
                param_idx[rows_key] = len(rows) - 1
            mapping.append([i, param_idx[rows_key]])
        out["map"] = np.array(mapping, dtype=np.int64)
        out["params"] = np.array(rows, dtype=np.float64)
        return out

    # ------------------------------------------------------------------
    def precision_(self, precision):
        """API parity no-op: assembly is kept in float64; consumers pick
        their compute dtype (Forces(precision=...))."""
        self.precision = precision

    def to_(self, device):
        """API parity: host-side tables have no device placement."""
        self.device = device

    def to_parmed(self, mol):
        """Export to a parmed.ParameterSet (requires parmed). For a
        dependency-free round trip use `to_yaml_ff`."""
        try:
            from parmed.parameters import ParameterSet
            from parmed.topologyobjects import (
                AngleType, AtomType, BondType, DihedralType,
                DihedralTypeList, ImproperType,
            )
        except ImportError as e:
            raise ImportError(
                "to_parmed requires the optional 'parmed' package; "
                "use to_yaml_ff() for a dependency-free export"
            ) from e
        from math import degrees

        from .io.periodictable import NUMBER_BY_SYMBOL

        prm = ParameterSet()
        at = np.asarray(self.atomtypes)
        uq = np.unique(at)
        sigma = self.nonbonded_params["params"][:, 0]
        epsilon = self.nonbonded_params["params"][:, 1]
        for i, a in enumerate(uq):
            idx = int(np.where(at == a)[0][0])
            el = str(mol.element[idx]) if mol.element is not None else "C"
            atype = AtomType(
                name=str(a), number=i + 1, mass=float(self.masses[idx, 0]),
                atomic_number=NUMBER_BY_SYMBOL.get(el, 6),
            )
            atype.sigma = float(sigma[i])
            atype.epsilon = float(epsilon[i])
            atype.sigma_14 = float(sigma[i])
            atype.epsilon_14 = float(epsilon[i])
            prm.atom_types[str(a)] = atype

        if self.bond_params is not None:
            for b, p in self.bond_params["map"]:
                key = tuple(at[self.bond_params["idx"][b]])
                bt = BondType(
                    k=float(self.bond_params["params"][p, 0]),
                    req=float(self.bond_params["params"][p, 1]),
                )
                prm.bond_types[key] = bt
                prm.bond_types[key[::-1]] = bt
        if self.angle_params is not None:
            for a_, p in self.angle_params["map"]:
                key = tuple(at[self.angle_params["idx"][a_]])
                t = AngleType(
                    k=float(self.angle_params["params"][p, 0]),
                    theteq=degrees(float(self.angle_params["params"][p, 1])),
                )
                prm.angle_types[key] = t
                prm.angle_types[key[::-1]] = t
        if self.dihedral_params is not None:
            dmap = np.asarray(self.dihedral_params["map"])
            dpar = np.asarray(self.dihedral_params["params"])
            for i in range(dpar.shape[0]):
                inst = int(dmap[dmap[:, 1] == i][0, 0])
                key = tuple(at[self.dihedral_params["idx"][inst]])
                if key not in prm.dihedral_types:
                    lst = DihedralTypeList()
                    prm.dihedral_types[key] = lst
                    prm.dihedral_types[key[::-1]] = lst
                scnb, scee = 2.0, 1.2
                if self.nonbonded_14_params is not None and len(
                    self.nonbonded_14_params.get("params", [])
                ):
                    idx14 = np.asarray(self.nonbonded_14_params["idx"])
                    quad = self.dihedral_params["idx"][inst]
                    ends = sorted([int(quad[0]), int(quad[3])])
                    hit = np.where(np.all(idx14 == np.array(ends), axis=1))[0]
                    if len(hit):
                        prow = int(self.nonbonded_14_params["map"][hit[0], 1])
                        scnb = round(
                            float(self.nonbonded_14_params["params"][prow, 2]), 2
                        )
                        scee = round(
                            float(self.nonbonded_14_params["params"][prow, 3]), 2
                        )
                prm.dihedral_types[key].append(
                    DihedralType(
                        phi_k=float(dpar[i, 0]), per=float(dpar[i, 2]),
                        phase=degrees(float(dpar[i, 1])), scee=scee, scnb=scnb,
                    )
                )
        if self.improper_params is not None:
            for d, p in self.improper_params["map"]:
                key = tuple(at[self.improper_params["idx"][d]])
                skey = sorted([key[0], key[1], key[3]])
                key = (skey[0], skey[1], key[2], skey[2])
                prow = np.asarray(self.improper_params["params"])[p]
                if prow[2] == 0:
                    prm.improper_types[key] = ImproperType(
                        psi_k=float(prow[0]), psi_eq=degrees(float(prow[1]))
                    )
                else:
                    prm.improper_periodic_types[key] = DihedralType(
                        phi_k=float(prow[0]), per=float(prow[2]),
                        phase=degrees(float(prow[1])),
                    )
        return prm

    def get_AB(self):
        sigma = self.nonbonded_params["params"][:, 0]
        epsilon = self.nonbonded_params["params"][:, 1]
        return calculate_AB(sigma, epsilon)

    def get_parameters(self, include=None, exclude=None):
        terms = ["charges", "lj", "bonds", "angles", "dihedrals", "impropers", "1-4"]
        if include is not None:
            terms = include
        if exclude is not None:
            terms = [t for t in terms if t not in exclude]
        src = {
            "charges": lambda: self.charges,
            "lj": lambda: self.nonbonded_params["params"],
            "bonds": lambda: self.bond_params["params"],
            "angles": lambda: self.angle_params["params"],
            "dihedrals": lambda: self.dihedral_params["params"],
            "impropers": lambda: self.improper_params["params"],
            "1-4": lambda: self.nonbonded_14_params["params"],
        }
        return {t: src[t]() for t in terms if t in src}


def to_yaml_ff(parameters, mol) -> dict:
    """Export assembled parameters back to the YAML force-field schema
    (the native equivalent of the reference's `to_parmed` OpenMM round-trip,
    parameters.py:320-435). Reloading the dict through YamlForcefield and
    re-assembling reproduces identical parameter tables (charges always
    come from the Molecule)."""
    from math import degrees

    at = np.asarray(mol.atomtype)
    uq = np.unique(at)
    out: dict = {"atomtypes": [str(a) for a in uq]}

    def key_of(types):
        return "(" + ", ".join(str(t) for t in types) + ")"

    if parameters.nonbonded_params is not None:
        lj = {}
        elec = {}
        for i, a in enumerate(uq):
            sigma, eps = parameters.nonbonded_params["params"][i]
            first = int(np.where(at == a)[0][0])
            lj[str(a)] = {
                "sigma": float(sigma), "epsilon": float(eps),
                "sigma14": float(sigma), "epsilon14": float(eps),
            }
            elec[str(a)] = {"charge": float(parameters.charges[first])}
        out["lj"] = lj
        out["electrostatics"] = elec

    out["masses"] = {
        str(a): float(parameters.masses[int(np.where(at == a)[0][0]), 0])
        for a in uq
    }

    def export_two_col(term, names):
        d = {}
        for inst, prow in term["map"]:
            types = at[term["idx"][inst]]
            d.setdefault(
                key_of(types),
                {names[0]: float(term["params"][prow, 0]),
                 names[1]: float(term["params"][prow, 1])},
            )
        return d

    if parameters.bond_params is not None:
        out["bonds"] = export_two_col(parameters.bond_params, ("k0", "req"))
    if parameters.angle_params is not None:
        d = {}
        for inst, prow in parameters.angle_params["map"]:
            types = at[parameters.angle_params["idx"][inst]]
            p = parameters.angle_params["params"][prow]
            d.setdefault(
                key_of(types),
                {"k0": float(p[0]), "theta0": degrees(float(p[1]))},
            )
        out["angles"] = d
    if parameters.dihedral_params is not None:
        d = {}
        for inst, prow in parameters.dihedral_params["map"]:
            types = at[parameters.dihedral_params["idx"][inst]]
            p = parameters.dihedral_params["params"][prow]
            ent = d.setdefault(key_of(types), {"terms": []})
            term = {
                "phi_k": float(p[0]),
                "phase": degrees(float(p[1])),
                "per": float(p[2]),
            }
            if term not in ent["terms"]:
                ent["terms"].append(term)
        # scnb/scee from the 1-4 tables
        if parameters.nonbonded_14_params is not None and len(
            parameters.nonbonded_14_params.get("params", [])
        ):
            nb14 = parameters.nonbonded_14_params
            for inst, prow in nb14["map"]:
                i, l = nb14["idx"][inst]
                # find a dihedral with these end atoms for the key
                didx = parameters.dihedral_params["idx"]
                cand = np.where(
                    ((didx[:, 0] == i) & (didx[:, 3] == l))
                    | ((didx[:, 0] == l) & (didx[:, 3] == i))
                )[0]
                if len(cand):
                    key = key_of(at[didx[cand[0]]])
                    if key in d:
                        d[key]["scnb"] = float(nb14["params"][prow, 2])
                        d[key]["scee"] = float(nb14["params"][prow, 3])
        out["dihedrals"] = d
    if parameters.improper_params is not None:
        d = {}
        for inst, prow in parameters.improper_params["map"]:
            types = at[parameters.improper_params["idx"][inst]]
            p = parameters.improper_params["params"][prow]
            d.setdefault(
                key_of(types),
                {"phi_k": float(p[0]), "phase": degrees(float(p[1])),
                 "per": float(p[2])},
            )
        out["impropers"] = d
    cmap_par = getattr(parameters, "cmap_params", None)
    if cmap_par is not None and len(cmap_par.get("idx", [])):
        d = {}
        for inst, prow in cmap_par["map"]:
            types = at[cmap_par["idx"][inst]]
            grid = np.asarray(cmap_par["tables"][prow])
            d.setdefault(
                key_of(types),
                {"resolution": int(grid.shape[0]),
                 "values": [float(v) for v in grid.reshape(-1)]},
            )
        out["cmap"] = d
    return out


def calculate_AB(sigma, epsilon):
    """Lorentz-Berthelot combination into 12-6 A/B tables
    (reference: torchmd/parameters.py:449-457)."""
    sigma = np.asarray(sigma, dtype=np.float64)
    epsilon = np.asarray(epsilon, dtype=np.float64)
    sigma_table = 0.5 * (sigma + sigma[:, None])
    eps_table = np.sqrt(epsilon * epsilon[:, None])
    s6 = sigma_table**6
    B = eps_table * 4 * s6
    A = eps_table * 4 * s6 * s6
    return A, B


def get_sigma_epsilon(Adiag, Bdiag):
    sigma = (Adiag / Bdiag) ** (1.0 / 6.0)
    epsilon = Bdiag / (4 * sigma**6)
    return sigma, epsilon


def _bond_neighbors(bonds) -> dict[int, set]:
    nb: dict[int, set] = defaultdict(set)
    for a, b in bonds:
        nb[int(a)].add(int(b))
        nb[int(b)].add(int(a))
    return nb


def _detect_improper_center(indexes, neighbors):
    """The improper center is the atom bonded to the other three
    (reference: torchmd/parameters.py:466-469)."""
    idxset = set(int(i) for i in indexes)
    for i in indexes:
        if len(neighbors.get(int(i), set()) & idxset) == 3:
            return int(i)
    raise RuntimeError(f"Could not detect improper center among atoms {indexes}")
