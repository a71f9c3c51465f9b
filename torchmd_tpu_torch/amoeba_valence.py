"""AMOEBA valence (bonded) terms from TINKER .prm files, the port of
`torchmd_tpu.amoeba_valence`.

Functional forms (TINKER ebond/eangle/eurey/eopbend/estrbnd/etors/
epitors/etortor; Ponder & Case, Adv. Protein Chem. 66:27, 2003):

  bond     E = bu K dr^2 (1 + c3 dr + c4 dr^2), dr = r - r0 (A)
  angle    E = au K dt^2 (1 + c3 dt + c4 dt^2 + c5 dt^3 + c6 dt^4),
           dt = theta - theta0 in degrees, au = (pi/180)^2 by default;
           'anglep' records take the same expansion
  ureybrad E = uu K dr^2 (1 + uc3 dr + uc4 dr^2) on the 1-3 distance
  opbend   E = ou K chi^2 (1 + oc3 chi + ...), chi the Wilson-Decius-
           Cross out-of-plane angle (degrees) of the a-b bond at the
           trigonal centre b
  strbnd   E = su (K1 dr_ab + K2 dr_cb) dt, su = pi/180 by default
  torsion  E = tu sum_n (V_n / 2)(1 + cos(n phi - gamma_n))
  pitors   E = pu K (1 + cos(2 phi - pi)) over the pi-orbital torsion
  tortors  a bicubic spline surface over two overlapping dihedrals (the
           CMAP machinery of `cmap.py`)

Instances come from the bond graph; parameters resolve by atom class
with forward/reverse keys and 0-wildcards in torsions; multi-theta0
angle records select by the hydrogens (mass < 3.5) on the centre
outside the angle. `AmoebaValence` is an external potential whose
tables live on the card unless it is given `device="cpu"`; its energy
is torch ops, forces by `torch.autograd`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .multipoles import BatchedExternal
from .systems import resolve_device

_DEG = math.pi / 180.0

# header keyword -> (dict key, default)
_SCALE_KEYS = {
    "bondunit": ("bond_unit", 1.0),
    "bond-cubic": ("bond_cubic", 0.0),
    "bond-quartic": ("bond_quartic", 0.0),
    "angleunit": ("angle_unit", _DEG * _DEG),
    "angle-cubic": ("angle_cubic", 0.0),
    "angle-quartic": ("angle_quartic", 0.0),
    "angle-pentic": ("angle_pentic", 0.0),
    "angle-sextic": ("angle_sextic", 0.0),
    "ureyunit": ("urey_unit", 1.0),
    "urey-cubic": ("urey_cubic", 0.0),
    "urey-quartic": ("urey_quartic", 0.0),
    "opbendunit": ("opbend_unit", _DEG * _DEG),
    "opbend-cubic": ("opbend_cubic", 0.0),
    "opbend-quartic": ("opbend_quartic", 0.0),
    "opbend-pentic": ("opbend_pentic", 0.0),
    "opbend-sextic": ("opbend_sextic", 0.0),
    "torsionunit": ("torsion_unit", 1.0),
    "strbndunit": ("strbnd_unit", _DEG),
    "pitorsunit": ("pitors_unit", 1.0),
    "tortorunit": ("tortor_unit", 1.0),
}


def parse_tinker_valence(text):
    """bond/angle/anglep/ureybrad/opbend/strbnd/torsion/pitors/tortors
    records and the header unit and anharmonicity keywords -> a dict of
    class-keyed tables."""
    out = {
        "scales": {k: v for k, v in _SCALE_KEYS.values()},
        "bond": {}, "angle": {}, "ureybrad": {}, "opbend": {},
        "strbnd": {}, "torsion": {}, "pitors": {}, "tortors": {},
    }
    tt_pending = None      # (classes, grid points still expected, triplets)
    for raw in text.splitlines():
        ln = raw.split("#")[0].strip()
        if not ln:
            continue
        parts = ln.split()
        if tt_pending is not None:
            cls5, left, trips = tt_pending
            if len(parts) == 3 and all(_is_float(p) for p in parts):
                trips.append(tuple(float(p) for p in parts))
                left -= 1
                tt_pending = None if left == 0 else (cls5, left, trips)
                if left == 0:
                    out["tortors"][cls5] = _tortors_grid(trips)
                continue
            raise ValueError(f"tortors {cls5}: expected {left} more grid lines")
        key = parts[0].lower()
        if key in _SCALE_KEYS:
            out["scales"][_SCALE_KEYS[key][0]] = float(parts[1])
        elif key == "bond":
            a, b = int(parts[1]), int(parts[2])
            out["bond"][_k2(a, b)] = (float(parts[3]), float(parts[4]))
        elif key in ("angle", "anglep"):
            a, b, c = (int(p) for p in parts[1:4])
            out["angle"][_k3(a, b, c)] = (float(parts[4]),
                                          [float(p) for p in parts[5:8]])
        elif key == "ureybrad":
            a, b, c = (int(p) for p in parts[1:4])
            out["ureybrad"][_k3(a, b, c)] = (float(parts[4]), float(parts[5]))
        elif key == "opbend":
            a, b, c, d = (int(p) for p in parts[1:5])
            out["opbend"][(a, b) + tuple(sorted((c, d)))] = float(parts[5])
        elif key == "strbnd":
            a, b, c = (int(p) for p in parts[1:4])
            k1, k2 = float(parts[4]), float(parts[5])
            # oriented: K1 couples the a-b bond, K2 the c-b bond
            out["strbnd"][(a, b, c)] = (k1, k2)
            out["strbnd"].setdefault((c, b, a), (k2, k1))
        elif key == "torsion":
            vals = parts[5:]
            out["torsion"][tuple(int(p) for p in parts[1:5])] = [
                (float(vals[i]), float(vals[i + 1]), int(float(vals[i + 2])))
                for i in range(0, len(vals) - 2, 3)]
        elif key == "pitors":
            out["pitors"][_k2(int(parts[1]), int(parts[2]))] = float(parts[3])
        elif key == "tortors":
            cls5 = tuple(int(p) for p in parts[1:6])
            tt_pending = (cls5, int(parts[6]) * int(parts[7]), [])
    return out


def _tortors_grid(trips):
    """(angle1, angle2, value) triplets -> the periodic (n, n) grid at
    angles (-180 + i h, -180 + j h), the duplicate +180 row and column
    dropped."""
    trips = np.asarray(trips, np.float64)
    a1, a2 = np.unique(trips[:, 0]), np.unique(trips[:, 1])
    h1, h2 = a1[1] - a1[0], a2[1] - a2[0]
    n1, n2 = int(round(360.0 / h1)), int(round(360.0 / h2))
    if n1 != n2:
        raise ValueError("tortors grids must be square in resolution")
    grid = np.zeros((n1, n1))
    for x, y, v in trips:
        grid[int(round((x + 180.0) / h1)) % n1, int(round((y + 180.0) / h2)) % n2] = v
    return grid


def _is_float(s):
    try:
        float(s)
        return True
    except ValueError:
        return False


def _k2(a, b):
    return (a, b) if a <= b else (b, a)


def _k3(a, b, c):
    return (a, b, c) if a <= c else (c, b, a)


def derive_valence_instances(natoms, bonds):
    """Angles (i, j, k) and proper torsions (i, j, k, l) from the bond
    graph, each unordered path once; and the 1-2 neighbour lists."""
    n12 = [[] for _ in range(natoms)]
    for a, b in np.asarray(bonds).reshape(-1, 2):
        n12[int(a)].append(int(b))
        n12[int(b)].append(int(a))
    angles = []
    for j in range(natoms):
        nb = sorted(n12[j])
        for x in range(len(nb)):
            for y in range(x + 1, len(nb)):
                angles.append((nb[x], j, nb[y]))
    seen = set()
    torsions = []
    for a, b in np.asarray(bonds).reshape(-1, 2):
        j, k = int(a), int(b)
        for i in n12[j]:
            if i == k:
                continue
            for l in n12[k]:
                if l == j or l == i:
                    continue
                t = (i, j, k, l)
                if t[::-1] in seen:
                    continue
                seen.add(t)
                torsions.append(t)
    return angles, torsions, n12


def _match_torsion(table, c):
    """Torsion class lookup with TINKER 0-wildcards, most specific first
    (exact, one-ended wildcard, double wildcard), both directions."""
    for key in (c, c[::-1],
                (0, c[1], c[2], c[3]), (c[3], c[2], c[1], 0),
                (c[0], c[1], c[2], 0), (0, c[2], c[1], c[0]),
                (0, c[1], c[2], 0), (0, c[2], c[1], 0)):
        if key in table:
            return table[key]
    return None


class AmoebaValence(BatchedExternal):
    """Every AMOEBA intramolecular term as one external potential
    (`energy_fn(pos, box)`; the box is ignored: valence terms never span
    a periodic image in the wrapped-molecule convention)."""

    part_name = "valence"

    def __init__(self, prm, atom_types, bonds, masses=None, device=None):
        self.device = resolve_device(device)
        if isinstance(prm, str):
            from .amoeba import parse_tinker_prm

            val, atoms = parse_tinker_valence(prm), parse_tinker_prm(prm)["atoms"]
        else:
            val, atoms = prm
        self.scales = val["scales"]
        atom_types = np.asarray(atom_types).reshape(-1)
        natoms = len(atom_types)
        cls = np.asarray([atoms.get(int(t), {}).get("class", int(t)) for t in atom_types])
        if masses is None:
            masses = np.asarray([atoms.get(int(t), {}).get("mass", 0.0) for t in atom_types])
        is_h = np.asarray(masses, np.float64).reshape(-1) < 3.5
        bonds = np.asarray(bonds).reshape(-1, 2)
        angles, torsions, n12 = derive_valence_instances(natoms, bonds)

        b_idx, b_prm = [], []
        for a, b in bonds:
            rec = val["bond"].get(_k2(int(cls[a]), int(cls[b])))
            if rec is not None:
                b_idx.append((a, b))
                b_prm.append(rec)
        self._bonds = self._table(b_idx, b_prm)

        # angles, with Urey-Bradley and stretch-bend on the same instances
        a_idx, a_prm, u_idx, u_prm, s_idx, s_prm = [], [], [], [], [], []
        for (i, j, k) in angles:
            ci, cj, ck = int(cls[i]), int(cls[j]), int(cls[k])
            rec = val["angle"].get((ci, cj, ck)) or val["angle"].get((ck, cj, ci))
            if rec is not None:
                kf, th_list = rec
                nh = sum(1 for x in n12[j] if x not in (i, k) and is_h[x])
                a_idx.append((i, j, k))
                a_prm.append((kf, th_list[min(nh, len(th_list) - 1)]))
            u = val["ureybrad"].get((ci, cj, ck)) or val["ureybrad"].get((ck, cj, ci))
            if u is not None:
                u_idx.append((i, k))
                u_prm.append(u)
            s = val["strbnd"].get((ci, cj, ck))
            s_rev = val["strbnd"].get((ck, cj, ci))
            if s is None and s_rev is not None:
                s = (s_rev[1], s_rev[0])
            if s is not None and rec is not None:
                rb1 = val["bond"].get(_k2(ci, cj))
                rb2 = val["bond"].get(_k2(ck, cj))
                if rb1 is not None and rb2 is not None:
                    s_idx.append((i, j, k))
                    s_prm.append((s[0], s[1], rb1[1], rb2[1], a_prm[-1][1]))
        self._angles = self._table(a_idx, a_prm)
        self._ureys = self._table(u_idx, u_prm)
        self._strbnd = self._table(s_idx, s_prm)

        # out-of-plane bends at trigonal centres
        o_idx, o_prm = [], []
        for j in range(natoms):
            if len(n12[j]) != 3:
                continue
            nb = n12[j]
            for a in nb:
                rest = tuple(sorted(int(cls[x]) for x in nb if x != a))
                for key in ((int(cls[a]), int(cls[j])) + rest,
                            (int(cls[a]), int(cls[j]), 0, 0)):
                    if key in val["opbend"]:
                        others = [x for x in nb if x != a]
                        o_idx.append((a, j, others[0], others[1]))
                        o_prm.append((val["opbend"][key],))
                        break
        self._opbend = self._table(o_idx, o_prm)

        t_idx, t_prm = [], []
        for (i, j, k, l) in torsions:
            terms = _match_torsion(val["torsion"], (int(cls[i]), int(cls[j]),
                                                    int(cls[k]), int(cls[l])))
            for (amp, phase, per) in terms or ():
                if amp != 0.0:
                    t_idx.append((i, j, k, l))
                    t_prm.append((amp, phase * _DEG, float(per)))
        self._torsions = self._table(t_idx, t_prm)

        # torsion-torsion: 5-atom chains, one bicubic surface per class key
        self._tortors = None
        tt_idx, tt_type, tt_grids = [], [], []
        if val["tortors"]:
            seen_ch, grid_slot = set(), {}
            for t in torsions:
                for tt in (t, t[::-1]):
                    for mdl in n12[tt[3]]:
                        if mdl in tt:
                            continue
                        ch = tt + (mdl,)
                        if ch in seen_ch or ch[::-1] in seen_ch:
                            continue
                        seen_ch.add(ch)
                        c5 = tuple(int(cls[x]) for x in ch)
                        grid = val["tortors"].get(c5)
                        if grid is None:
                            g_r = val["tortors"].get(c5[::-1])
                            # a reversed match swaps the two dihedrals
                            grid = None if g_r is None else g_r.T
                        if grid is None:
                            continue
                        if c5 not in grid_slot:
                            grid_slot[c5] = len(tt_grids)
                            tt_grids.append(grid)
                        tt_idx.append(ch[:4] + ch[1:])
                        tt_type.append(grid_slot[c5])
        if tt_idx:
            from .cmap import CMapTable, build_cmap_coeff_table

            self._tortors = CMapTable(
                idx=self._ints(tt_idx), type=self._ints(tt_type),
                coeffs=torch.as_tensor(build_cmap_coeff_table(tt_grids), device=self.device))

        # pi-torsions: bonded trigonal-trigonal pairs
        p_idx, p_prm = [], []
        for a, b in bonds:
            a, b = int(a), int(b)
            if len(n12[a]) != 3 or len(n12[b]) != 3:
                continue
            rec = val["pitors"].get(_k2(int(cls[a]), int(cls[b])))
            if rec is None:
                continue
            ra = [x for x in n12[a] if x != b]
            rb = [x for x in n12[b] if x != a]
            p_idx.append((ra[0], ra[1], a, b, rb[0], rb[1]))
            p_prm.append((rec,))
        self._pitors = self._table(p_idx, p_prm)

    def _ints(self, v):
        return torch.as_tensor(np.asarray(v, np.int64), device=self.device)

    def _table(self, idx, prm):
        if not idx:
            return None
        return self._ints(idx), torch.as_tensor(np.asarray(prm, np.float64),
                                                device=self.device)

    # ------------------------------------------------------------------
    def energy_fn(self, pos, box=None):
        s = self.scales
        e = torch.zeros((), dtype=pos.dtype, device=pos.device)

        def rows(table):
            idx, prm = table
            return idx, prm.to(pos.dtype)

        if self._bonds is not None:
            idx, prm = rows(self._bonds)
            dr = _dist(pos, idx[:, 0], idx[:, 1]) - prm[:, 1]
            e = e + s["bond_unit"] * (prm[:, 0] * dr * dr * (
                1.0 + s["bond_cubic"] * dr + s["bond_quartic"] * dr * dr)).sum()
        if self._angles is not None:
            idx, prm = rows(self._angles)
            dt = _angle_deg(pos, idx) - prm[:, 1]
            poly = 1.0 + dt * (s["angle_cubic"] + dt * (s["angle_quartic"] + dt * (
                s["angle_pentic"] + dt * s["angle_sextic"])))
            e = e + s["angle_unit"] * (prm[:, 0] * dt * dt * poly).sum()
        if self._ureys is not None:
            idx, prm = rows(self._ureys)
            dr = _dist(pos, idx[:, 0], idx[:, 1]) - prm[:, 1]
            e = e + s["urey_unit"] * (prm[:, 0] * dr * dr * (
                1.0 + s["urey_cubic"] * dr + s["urey_quartic"] * dr * dr)).sum()
        if self._strbnd is not None:
            idx, prm = rows(self._strbnd)
            dt = _angle_deg(pos, idx) - prm[:, 4]
            dr1 = _dist(pos, idx[:, 0], idx[:, 1]) - prm[:, 2]
            dr2 = _dist(pos, idx[:, 2], idx[:, 1]) - prm[:, 3]
            e = e + s["strbnd_unit"] * ((prm[:, 0] * dr1 + prm[:, 1] * dr2) * dt).sum()
        if self._opbend is not None:
            idx, prm = rows(self._opbend)
            chi = _opbend_deg(pos, idx)
            poly = 1.0 + chi * (s["opbend_cubic"] + chi * (s["opbend_quartic"] + chi * (
                s["opbend_pentic"] + chi * s["opbend_sextic"])))
            e = e + s["opbend_unit"] * (prm[:, 0] * chi * chi * poly).sum()
        if self._torsions is not None:
            idx, prm = rows(self._torsions)
            phi = _dihedral(pos, idx)
            e = e + s["torsion_unit"] * (
                0.5 * prm[:, 0] * (1.0 + torch.cos(prm[:, 2] * phi - prm[:, 1]))).sum()
        if self._pitors is not None:
            idx, prm = rows(self._pitors)
            phi = _pitors_angle(pos, idx)
            e = e + s["pitors_unit"] * (prm[:, 0] * (1.0 + torch.cos(2.0 * phi - math.pi))).sum()
        if self._tortors is not None:
            e = e + s["tortor_unit"] * self._tortor_energy(pos)
        return e

    def _tortor_energy(self, pos):
        """The bicubic surface of `cmap.cmap_energy_rows` at this module's
        IUPAC-sign dihedrals (TINKER's convention)."""
        tab = self._tortors
        n = tab.coeffs.shape[1]
        h = 2.0 * math.pi / n

        def locate(ang):
            x = (ang + math.pi) / h
            cell = torch.floor(x)
            return torch.remainder(cell.to(torch.int64), n), x - cell

        ci, t = locate(_dihedral(pos, tab.idx[:, 0:4]))
        cj, u = locate(_dihedral(pos, tab.idx[:, 4:8]))
        a = tab.coeffs.to(pos.dtype)[tab.type, ci, cj]
        one = torch.ones_like(t)
        tp = torch.stack([one, t, t * t, t * t * t], -1)
        up = torch.stack([one, u, u * u, u * u * u], -1)
        return torch.einsum("cp,cpq,cq->c", tp, a, up).sum()


def _norm(v):
    return torch.linalg.vector_norm(v, dim=-1)


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _dist(pos, i, j):
    return _norm(pos[i] - pos[j])


def _angle_deg(pos, idx):
    u = pos[idx[:, 0]] - pos[idx[:, 1]]
    v = pos[idx[:, 2]] - pos[idx[:, 1]]
    return torch.atan2(_norm(_cross(u, v)), (u * v).sum(-1)) / _DEG


def _dihedral_from(b1, b2, b3):
    n1, n2 = _cross(b1, b2), _cross(b2, b3)
    m1 = _cross(n1, b2 / _norm(b2)[:, None])
    return torch.atan2((m1 * n2).sum(-1), (n1 * n2).sum(-1))


def _dihedral(pos, idx):
    return _dihedral_from(pos[idx[:, 1]] - pos[idx[:, 0]], pos[idx[:, 2]] - pos[idx[:, 1]],
                          pos[idx[:, 3]] - pos[idx[:, 2]])


def _opbend_deg(pos, idx):
    """Wilson-Decius-Cross out-of-plane angle (degrees) between the b->a
    bond and the c-b-d plane, rows (a, b, c, d)."""
    a = pos[idx[:, 0]] - pos[idx[:, 1]]
    n = _cross(pos[idx[:, 2]] - pos[idx[:, 1]], pos[idx[:, 3]] - pos[idx[:, 1]])
    nn_na = _norm(n) * _norm(a)
    sin_chi = (n * a).sum(-1) / torch.where(nn_na > 0, nn_na, torch.ones_like(nn_na))
    return torch.abs(torch.arcsin(torch.clamp(sin_chi, -1.0, 1.0))) / _DEG


def _pitors_angle(pos, idx):
    """Pi-orbital torsion (TINKER epitors) of rows (a1, a2, b, c, c1, c2)
    with the b=c double bond: the dihedral of the orbital normals about
    the bond axis."""
    b, c = pos[idx[:, 2]], pos[idx[:, 3]]
    nb = _cross(pos[idx[:, 0]] - b, pos[idx[:, 1]] - b)
    nc = _cross(pos[idx[:, 4]] - c, pos[idx[:, 5]] - c)
    return _dihedral_from(-nb, c - b, nc)


def make_amoeba_valence(prm_text, atom_types, bonds, masses=None, device=None):
    """One-call valence potential from a TINKER .prm text."""
    return AmoebaValence(prm_text, atom_types, bonds, masses=masses, device=device)
