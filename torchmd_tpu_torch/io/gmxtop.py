"""GROMACS topology (.top/.itp) parser.

New capability beyond the reference (which has no GROMACS support at all):
parses the GROMACS topology format -- the distribution vehicle for OPLS-AA,
the AMBER/CHARMM ports, GROMOS and Martini force fields -- into plain
Python structures. Parameter *conversion* to the framework's
kcal/mol/Angstrom conventions lives in `forcefields.ff_gromacs`; this
module only tokenizes sections and resolves the preprocessor.

Supported preprocessor subset: #include (with search dirs), #define /
#undef (flags and value macros, substituted into data fields),
#ifdef/#ifndef/#else/#endif. Line continuations (backslash) and ';'
comments are handled.

Sections parsed: defaults, atomtypes, bondtypes, pairtypes, angletypes,
dihedraltypes, constrainttypes, nonbond_params, moleculetype, atoms,
bonds, pairs, angles, dihedrals, exclusions, settles, constraints,
virtual_sites2, virtual_sites3, position_restraints (recorded),
system, molecules. Unknown sections are skipped with a record of their
names (strict callers can raise).
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field

import numpy as np


@dataclass
class GmxMoleculeType:
    name: str
    nrexcl: int = 3
    # each atom: dict(nr, type, resid, resname, name, cgnr, charge, mass)
    atoms: list = field(default_factory=list)
    # bonded entries: (indices tuple (0-based), funct, params list[float]|None)
    bonds: list = field(default_factory=list)
    pairs: list = field(default_factory=list)
    angles: list = field(default_factory=list)
    dihedrals: list = field(default_factory=list)
    exclusions: list = field(default_factory=list)   # (i, [j...])
    settles: list = field(default_factory=list)      # (i, funct, doh, dhh) nm
    constraints: list = field(default_factory=list)  # ((i,j), funct, [b0]) nm
    vsites2: list = field(default_factory=list)      # ((s,i,j), funct, [a])
    vsites3: list = field(default_factory=list)      # ((s,i,j,k), funct, prm)
    vsites4: list = field(default_factory=list)      # ((s,i,j,k,l), funct, prm)
    position_restraints: list = field(default_factory=list)
    distance_restraints: list = field(default_factory=list)
    dihedral_restraints: list = field(default_factory=list)


@dataclass
class GmxTopology:
    # [defaults]: nbfunc, comb_rule, gen_pairs, fudgeLJ, fudgeQQ
    defaults: dict = field(default_factory=lambda: {
        "nbfunc": 1, "comb_rule": 1, "gen_pairs": False,
        "fudgeLJ": 1.0, "fudgeQQ": 1.0,
    })
    # name -> dict(btype, atnum, mass, charge, ptype, V, W)  (raw GROMACS
    # units: V/W are sigma[nm]/eps[kJ] for comb rules 2-3, C6/C12 for 1)
    atomtypes: dict = field(default_factory=dict)
    # (bt_i, bt_j, funct) -> params  [raw]
    bondtypes: dict = field(default_factory=dict)
    pairtypes: dict = field(default_factory=dict)
    angletypes: dict = field(default_factory=dict)
    # (bt_i..bt_l, funct) -> list of params rows (funct 9 stacks rows)
    dihedraltypes: dict = field(default_factory=dict)
    constrainttypes: dict = field(default_factory=dict)
    # (t_i, t_j) -> (V, W) raw overrides ([nonbond_params], NBFIX-like)
    nonbond_params: dict = field(default_factory=dict)
    moleculetypes: dict = field(default_factory=dict)  # name -> GmxMoleculeType
    system_name: str = ""
    molecules: list = field(default_factory=list)      # [(name, count)...]
    skipped_sections: list = field(default_factory=list)
    source_files: list = field(default_factory=list)   # incl. #includes


_SECTION_RE = re.compile(r"^\[\s*([a-zA-Z0-9_\-]+)\s*\]")


def _strip(line: str) -> str:
    i = line.find(";")
    if i >= 0:
        line = line[:i]
    return line.strip()


def _preprocess(path, include_dirs, defines, out_lines, depth=0,
                files=None):
    """Resolve includes/conditionals; append (source, fields-line) to
    out_lines. `defines` maps NAME -> None (flag) or substitution string.
    `files` (optional list) collects every file opened, for cache
    invalidation."""
    if depth > 40:
        raise ValueError(f"#include nesting too deep at {path}")
    if files is not None:
        files.append(os.path.abspath(path))
    with open(path) as fh:
        raw = fh.read().splitlines()

    # join continuation lines
    lines, acc = [], ""
    for ln in raw:
        if ln.rstrip().endswith("\\"):
            acc += ln.rstrip()[:-1] + " "
            continue
        lines.append(acc + ln)
        acc = ""
    if acc:
        lines.append(acc)

    # conditional stack: each entry is (taking: bool, seen_else: bool)
    stack = []

    def active():
        return all(t for t, _ in stack)

    for ln in lines:
        s = _strip(ln)
        if s.startswith("#"):
            parts = s.split()
            d = parts[0]
            if d == "#ifdef":
                stack.append((parts[1] in defines, False))
            elif d == "#ifndef":
                stack.append((parts[1] not in defines, False))
            elif d == "#else":
                if not stack:
                    raise ValueError(f"{path}: #else without #if")
                t, seen = stack[-1]
                if seen:
                    raise ValueError(f"{path}: duplicate #else")
                # only flip if the enclosing scope is active
                outer = all(t2 for t2, _ in stack[:-1])
                stack[-1] = ((not t) and outer, True)
            elif d == "#endif":
                if not stack:
                    raise ValueError(f"{path}: #endif without #if")
                stack.pop()
            elif not active():
                continue
            elif d == "#define":
                name = parts[1]
                defines[name] = " ".join(parts[2:]) if len(parts) > 2 else None
            elif d == "#undef":
                defines.pop(parts[1], None)
            elif d == "#include":
                m = re.search(r'[<"]([^">]+)[">]', s)
                if not m:
                    raise ValueError(f"{path}: malformed #include: {s}")
                inc = m.group(1)
                for base in [os.path.dirname(path)] + list(include_dirs):
                    cand = os.path.join(base, inc)
                    if os.path.exists(cand):
                        _preprocess(cand, include_dirs, defines, out_lines,
                                    depth + 1, files=files)
                        break
                else:
                    raise FileNotFoundError(
                        f"{path}: #include \"{inc}\" not found (searched "
                        f"{[os.path.dirname(path)] + list(include_dirs)})"
                    )
            # unknown directives (#error outside active blocks etc.)
            elif d == "#error":
                raise ValueError(f"{path}: #error {' '.join(parts[1:])}")
            continue
        if not s or not active():
            continue
        # value-macro substitution (GROMOS-style '#define gb_1 0.1 3e5')
        if defines:
            toks = s.split()
            if any(t in defines and defines[t] is not None for t in toks):
                toks = [
                    defines[t] if (t in defines and defines[t] is not None)
                    else t
                    for t in toks
                ]
                s = " ".join(toks)
        out_lines.append((path, s))


def _to_num(tok):
    try:
        return int(tok)
    except ValueError:
        return float(tok)


def _floats(toks):
    return [float(t) for t in toks]


def parse_top(path, include_dirs=(), defines=None, strict=False):
    """Parse a .top/.itp file (resolving the preprocessor) -> GmxTopology."""
    top = GmxTopology()
    defs = dict(defines or {})
    lines: list = []
    files: list = []
    _preprocess(os.path.abspath(path), tuple(include_dirs), defs, lines,
                files=files)
    top.source_files = sorted(set(files))

    section = None
    cur: GmxMoleculeType | None = None

    for src, s in lines:
        m = _SECTION_RE.match(s)
        if m:
            section = m.group(1).lower()
            if section == "moleculetype":
                cur = None  # name comes on the first data line
            continue
        toks = s.split()
        if section is None:
            continue
        try:
            if section == "defaults":
                top.defaults["nbfunc"] = int(toks[0])
                top.defaults["comb_rule"] = int(toks[1])
                if len(toks) > 2:
                    top.defaults["gen_pairs"] = toks[2].lower() in (
                        "yes", "true", "1")
                if len(toks) > 3:
                    top.defaults["fudgeLJ"] = float(toks[3])
                if len(toks) > 4:
                    top.defaults["fudgeQQ"] = float(toks[4])
            elif section == "atomtypes":
                top.atomtypes.update([_parse_atomtype(toks)])
            elif section == "bondtypes":
                key = (toks[0], toks[1], int(toks[2]))
                top.bondtypes[key] = _floats(toks[3:])
            elif section == "pairtypes":
                key = (toks[0], toks[1], int(toks[2]))
                top.pairtypes[key] = _floats(toks[3:])
            elif section == "angletypes":
                key = (toks[0], toks[1], toks[2], int(toks[3]))
                top.angletypes[key] = _floats(toks[4:])
            elif section == "dihedraltypes":
                _parse_dihedraltype(top.dihedraltypes, toks)
            elif section == "constrainttypes":
                key = (toks[0], toks[1], int(toks[2]))
                top.constrainttypes[key] = _floats(toks[3:])
            elif section == "nonbond_params":
                # ai aj funct V W   (funct always 1 for LJ)
                top.nonbond_params[(toks[0], toks[1])] = (
                    float(toks[3]), float(toks[4]))
            elif section == "moleculetype":
                cur = GmxMoleculeType(name=toks[0], nrexcl=int(toks[1]))
                top.moleculetypes[cur.name] = cur
            elif section == "atoms":
                # nr type resnr residue atom cgnr [charge [mass ...]]
                at = {
                    "nr": int(toks[0]), "type": toks[1],
                    "resid": int(toks[2]), "resname": toks[3],
                    "name": toks[4],
                    "cgnr": int(toks[5]) if len(toks) > 5 else 0,
                    "charge": float(toks[6]) if len(toks) > 6 else None,
                    "mass": float(toks[7]) if len(toks) > 7 else None,
                }
                cur.atoms.append(at)
            elif section in ("bonds", "pairs", "angles", "dihedrals"):
                arity = {"bonds": 2, "pairs": 2, "angles": 3,
                         "dihedrals": 4}[section]
                idx = tuple(int(t) - 1 for t in toks[:arity])
                funct = int(toks[arity])
                prm = _floats(toks[arity + 1:]) or None
                getattr(cur, section).append((idx, funct, prm))
            elif section == "exclusions":
                cur.exclusions.append(
                    (int(toks[0]) - 1, [int(t) - 1 for t in toks[1:]])
                )
            elif section == "settles":
                cur.settles.append(
                    (int(toks[0]) - 1, int(toks[1]),
                     float(toks[2]), float(toks[3]))
                )
            elif section == "constraints":
                idx = (int(toks[0]) - 1, int(toks[1]) - 1)
                cur.constraints.append((idx, int(toks[2]), _floats(toks[3:])))
            elif section == "virtual_sites2":
                idx = tuple(int(t) - 1 for t in toks[:3])
                cur.vsites2.append((idx, int(toks[3]), _floats(toks[4:])))
            elif section == "virtual_sites3":
                idx = tuple(int(t) - 1 for t in toks[:4])
                cur.vsites3.append((idx, int(toks[4]), _floats(toks[5:])))
            elif section == "virtual_sites4":
                idx = tuple(int(t) - 1 for t in toks[:5])
                cur.vsites4.append((idx, int(toks[5]), _floats(toks[6:])))
            elif section == "position_restraints":
                cur.position_restraints.append(
                    ((int(toks[0]) - 1,), int(toks[1]), _floats(toks[2:]))
                )
            elif section == "distance_restraints":
                # ai aj funct label type low up1 up2 kfac
                idx = (int(toks[0]) - 1, int(toks[1]) - 1)
                cur.distance_restraints.append(
                    (idx, int(toks[2]), _floats(toks[3:]))
                )
            elif section == "dihedral_restraints":
                # ai aj ak al funct phi0 dphi kfac
                idx = tuple(int(t) - 1 for t in toks[:4])
                cur.dihedral_restraints.append(
                    (idx, int(toks[4]), _floats(toks[5:]))
                )
            elif section == "system":
                top.system_name = s
            elif section == "molecules":
                top.molecules.append((toks[0], int(toks[1])))
            else:
                if section not in top.skipped_sections:
                    top.skipped_sections.append(section)
                    if strict:
                        raise ValueError(
                            f"{src}: unsupported section [{section}]"
                        )
        except (ValueError, IndexError) as e:
            if isinstance(e, ValueError) and "unsupported section" in str(e):
                raise
            raise ValueError(
                f"{src}: cannot parse [{section}] line: '{s}' ({e})"
            ) from e

    if not top.molecules and top.moleculetypes:
        # bare .itp: treat the single moleculetype as the system
        if len(top.moleculetypes) == 1:
            name = next(iter(top.moleculetypes))
            top.molecules = [(name, 1)]
    return top


def _parse_atomtype(toks):
    """[atomtypes] lines come in several shapes:
         name                       mass charge ptype V W
         name  btype                mass charge ptype V W
         name  atnum                mass charge ptype V W
         name  btype  atnum         mass charge ptype V W
    Locate the ptype letter (A/S/V/D) to anchor the layout."""
    pt_pos = None
    for i in range(2, min(len(toks), 6)):
        if toks[i] in ("A", "S", "V", "D") and len(toks) >= i + 3:
            # fields after ptype must be numeric (V W)
            try:
                float(toks[i + 1]), float(toks[i + 2])
                float(toks[i - 1]), float(toks[i - 2])  # charge, mass
                pt_pos = i
                break
            except ValueError:
                continue
    if pt_pos is None:
        raise ValueError(f"unrecognized atomtypes layout: {toks}")
    name = toks[0]
    head = toks[1:pt_pos - 2]
    btype, atnum = name, None
    for h in head:
        try:
            atnum = int(h)
        except ValueError:
            btype = h
    return name, {
        "btype": btype,
        "atnum": atnum,
        "mass": float(toks[pt_pos - 2]),
        "charge": float(toks[pt_pos - 1]),
        "ptype": toks[pt_pos],
        "V": float(toks[pt_pos + 1]),
        "W": float(toks[pt_pos + 2]),
    }


def _parse_dihedraltype(table, toks):
    """[dihedraltypes] rows: modern form has 4 type columns + funct;
    the old 2-type form (GROMACS pre-4.x, still emitted by some tools)
    gives the two INNER types for propers: 'bt_j bt_k funct ...'."""
    def _is_number(tok):
        try:
            float(tok)
            return True
        except ValueError:
            return False

    four = False
    if len(toks) >= 5:
        try:
            int(toks[4])
            # type columns are names, never pure numbers -- guards against
            # old-form lines whose parameters happen to be integers
            # ('X X 1 180 10 2' is 2-type funct 1, not 4-type funct 10)
            four = not any(_is_number(t) for t in toks[:4])
        except ValueError:
            four = False
    if four:
        key = (toks[0], toks[1], toks[2], toks[3], int(toks[4]))
        prm = _floats(toks[5:])
    else:
        funct2 = int(toks[2])
        if funct2 in (2, 4):
            # old 2-atom improper types name the OUTER atoms (i, l)
            key = (toks[0], "X", "X", toks[1], funct2)
        else:
            # old 2-atom proper types name the INNER atoms (j, k)
            key = ("X", toks[0], toks[1], "X", funct2)
        prm = _floats(toks[3:])
    funct = key[4]
    if funct == 9:
        table.setdefault(key, []).append(prm)
    else:
        table[key] = [prm]


# ----------------------------------------------------------------------
# Molecule building (replication per [molecules])
# ----------------------------------------------------------------------

def build_molecule_arrays(top: GmxTopology):
    """Flatten the [molecules] stack into whole-system arrays.

    Returns a dict with the Molecule fields (atomtype, charge, masses,
    name, resname, resid, bonds, angles, dihedrals, impropers) plus the
    replicated per-instance interaction lists used by the parameter
    assembly:
      bonds_full / pairs_full / angles_full / dihedrals_full:
          (global idx tuple, funct, inline params|None, molname)
      exclusions_full: (i, [j...]) global
      settles_full:    (o, h1, h2, doh_nm, dhh_nm)
      constraints_full:(i, j, funct, b0_nm)
      vsites_full:     (idx tuple, nsites_kind, funct, params)
    Dihedrals with funct 2/4 are classified as impropers.
    """
    atomtype, charge, masses = [], [], []
    names, resnames, resids = [], [], []
    molid = []
    bonds_full, pairs_full = [], []
    angles_full, dihedrals_full = [], []
    exclusions_full, settles_full, constraints_full = [], [], []
    vsites_full = []
    posres_full = []  # (global atom, funct, [params]) raw units
    distres_full = []
    dihres_full = []
    bond_idx, angle_idx, dih_idx, impr_idx = [], [], [], []

    offset = 0
    resid_offset = 0
    nmol = 0
    for mname, count in top.molecules:
        if mname not in top.moleculetypes:
            raise ValueError(
                f"[molecules] references undefined moleculetype '{mname}'"
            )
        mt = top.moleculetypes[mname]
        nat = len(mt.atoms)
        for c in range(count):
            maxres = 0
            for a in mt.atoms:
                atomtype.append(a["type"])
                q = a["charge"]
                if q is None:
                    q = top.atomtypes.get(a["type"], {}).get("charge", 0.0)
                charge.append(q)
                mass = a["mass"]
                if mass is None:
                    at = top.atomtypes.get(a["type"])
                    if at is None:
                        raise ValueError(
                            f"atom type '{a['type']}' of {mname} not in "
                            "[atomtypes] and no inline mass"
                        )
                    mass = at["mass"]
                masses.append(mass)
                names.append(a["name"])
                resnames.append(a["resname"])
                resids.append(a["resid"] + resid_offset)
                molid.append(nmol)
                maxres = max(maxres, a["resid"])
            resid_offset += maxres
            nmol += 1

            def g(i):
                return i + offset

            for idx, funct, prm in mt.bonds:
                gi = tuple(g(i) for i in idx)
                bonds_full.append((gi, funct, prm, mname))
                if funct != 6:
                    # funct 6 restrains without connectivity: keep it out
                    # of the molecule graph (wrapping, constraints)
                    bond_idx.append(gi)
            for idx, funct, prm in mt.pairs:
                pairs_full.append((tuple(g(i) for i in idx), funct, prm,
                                   mname))
            for idx, funct, prm in mt.angles:
                gi = tuple(g(i) for i in idx)
                angles_full.append((gi, funct, prm, mname))
                angle_idx.append(gi)
            for idx, funct, prm in mt.dihedrals:
                gi = tuple(g(i) for i in idx)
                dihedrals_full.append((gi, funct, prm, mname))
                if funct in (2, 4):
                    impr_idx.append(gi)
                else:
                    dih_idx.append(gi)
            for i, js in mt.exclusions:
                exclusions_full.append((g(i), [g(j) for j in js]))
            for o, funct, doh, dhh in mt.settles:
                if nat < o + 3:
                    raise ValueError(
                        f"[settles] in {mname}: expected O,H,H at {o}..{o+2}"
                    )
                settles_full.append((g(o), g(o + 1), g(o + 2), doh, dhh))
            for (i, j), funct, prm in mt.constraints:
                b0 = prm[0] if prm else None
                if b0 is None:
                    bt1 = top.atomtypes.get(
                        mt.atoms[i]["type"], {}).get("btype",
                                                     mt.atoms[i]["type"])
                    bt2 = top.atomtypes.get(
                        mt.atoms[j]["type"], {}).get("btype",
                                                     mt.atoms[j]["type"])
                    ct = (top.constrainttypes.get((bt1, bt2, funct))
                          or top.constrainttypes.get((bt2, bt1, funct)))
                    if ct is None:
                        raise ValueError(
                            f"no constraint parameters for {bt1}-{bt2} "
                            f"funct {funct} in {mname}"
                        )
                    b0 = ct[0]
                constraints_full.append((g(i), g(j), funct, b0))
            for idx, funct, prm in mt.vsites2:
                vsites_full.append((tuple(g(i) for i in idx), 2, funct, prm))
            for idx, funct, prm in mt.vsites3:
                vsites_full.append((tuple(g(i) for i in idx), 3, funct, prm))
            for idx, funct, prm in mt.vsites4:
                vsites_full.append((tuple(g(i) for i in idx), 4, funct, prm))
            for idx, funct, prm in mt.position_restraints:
                posres_full.append((g(idx[0]), funct, prm))
            for idx, funct, prm in mt.distance_restraints:
                distres_full.append(
                    ((g(idx[0]), g(idx[1])), funct, prm)
                )
            for idx, funct, prm in mt.dihedral_restraints:
                dihres_full.append(
                    (tuple(g(i) for i in idx), funct, prm)
                )
            offset += nat

    return {
        "atomtype": np.asarray(atomtype, dtype=object),
        "charge": np.asarray(charge, dtype=np.float64),
        "masses": np.asarray(masses, dtype=np.float64),
        "name": np.asarray(names, dtype=object),
        "resname": np.asarray(resnames, dtype=object),
        "resid": np.asarray(resids, dtype=np.int64),
        "molid": np.asarray(molid, dtype=np.int64),
        "natoms": offset,
        "bond_idx": np.asarray(bond_idx, np.int64).reshape(-1, 2),
        "angle_idx": np.asarray(angle_idx, np.int64).reshape(-1, 3),
        "dih_idx": np.asarray(dih_idx, np.int64).reshape(-1, 4),
        "impr_idx": np.asarray(impr_idx, np.int64).reshape(-1, 4),
        "bonds_full": bonds_full,
        "pairs_full": pairs_full,
        "angles_full": angles_full,
        "dihedrals_full": dihedrals_full,
        "exclusions_full": exclusions_full,
        "settles_full": settles_full,
        "constraints_full": constraints_full,
        "vsites_full": vsites_full,
        "posres_full": posres_full,
        "distres_full": distres_full,
        "dihres_full": dihres_full,
    }
