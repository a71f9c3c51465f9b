"""Holonomic constraints on torch tensors: SHAKE/RATTLE bonds, SETTLE
rigid waters, and hydrogen mass repartitioning.

Counterpart of `torchmd_tpu.constraints`:

  - SHAKE (positions) and RATTLE (velocities) as the JAX package runs
    them: parallel Jacobi sweeps over every constraint at once, a fixed
    iteration count (default 50) and under-relaxation 0.5, with the
    constraint gradients linearised on the pre-step geometry `pos_ref`.
    Each sweep is one gather, a few elementwise ops and one `index_add_`
    on the device; the index tensors are built once and nothing is read
    back to the host inside the loop;
  - SETTLE: analytic position constraints for rigid 3-site waters
    (Miyamoto & Kollman 1992) and the exact 3x3 RATTLE velocity solve, in
    the gather form (rows picked by index, written back out of place).

Every function works on (..., natoms, 3) tensors, so a leading replica
axis passes through.

Which atoms are "light" (hydrogens, <= 3.5 amu) is read from the force
field's masses, `parameters.masses`, never from the masses the dynamics
uses: hydrogen mass repartitioning (`repartition_hydrogen_masses`) gives
the System its own masses and leaves the parameters alone. The JAX
package picks the light atoms from the repartitioned masses, so at an
HMR factor of 4 its hydrogens (4.03 amu) stop being light and methyl
carbons (2.94 amu) start: on thrombin it constrains 588 bonds, mostly
C-C, instead of the 2,319 X-H bonds. SHAKE's inverse masses and SETTLE's
masses are the dynamical (repartitioned) ones.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

H_MASS_CUT = 3.5  # amu: atoms at most this heavy count as hydrogens


class ConstraintSet(NamedTuple):
    """SHAKE/RATTLE bond constraints, with the index tensors of the sweeps."""

    pairs: torch.Tensor   # (C, 2) int64 atom indices
    r0: torch.Tensor      # (C,) target distances
    invm: torch.Tensor    # (natoms, 1) inverse dynamical masses
    iterations: int
    relax: float          # under-relaxation factor of the Jacobi sweeps
    ij: torch.Tensor      # (2C,) int64: the i column, then the j column
    wsign: torch.Tensor   # (2C, 1): -1/m_i for the i rows, +1/m_j for the j rows
    atoms: torch.Tensor   # (K,) int64: every constrained atom once
    anchor: torch.Tensor  # (K,) int64: the heaviest atom of its cluster


def _light(parameters, h_mass_cut=H_MASS_CUT):
    """Light-atom mask from the force field's masses (see the module
    docstring for why not the dynamical ones)."""
    return np.asarray(parameters.masses, np.float64).reshape(-1) <= h_mass_cut


def _constrained_bonds(parameters, mode, h_mass_cut=H_MASS_CUT):
    """(pairs (C, 2), r0 (C,)) numpy of the bonds `mode` constrains:
    "hbonds" those with a light atom (by the force field's masses),
    "allbonds" every bond (with the reference water model's zero-k H-H
    spacer bonds this makes water rigid)."""
    if parameters.bond_params is None:
        return np.zeros((0, 2), np.int64), np.zeros(0)
    idx, r0 = _bond_tables(parameters)
    if mode == "allbonds":
        keep = np.ones(len(idx), dtype=bool)
    elif mode == "hbonds":
        light = _light(parameters, h_mass_cut)
        keep = light[idx[:, 0]] | light[idx[:, 1]]
    else:
        raise ValueError(f"Unknown constraint mode: {mode}")
    return idx[keep], r0[keep]


def build_constraints(parameters, masses, mode="hbonds", iterations=50,
                      relax=0.5, h_mass_cut=H_MASS_CUT, device="cpu",
                      dtype=torch.float64) -> Optional[ConstraintSet]:
    """SHAKE/RATTLE constraints of the bonds `mode` names
    (`_constrained_bonds`); `masses` are the dynamical masses, which give
    the inverse masses. None when no bond qualifies."""
    if mode in (None, "none", False):
        return None
    pairs, r0 = _constrained_bonds(parameters, mode, h_mass_cut)
    return _constraint_set(pairs, r0, masses, iterations, relax, device, dtype)


def _constraint_set(pairs, r0, masses, iterations, relax, device, dtype):
    if len(pairs) == 0:
        return None
    pairs = np.asarray(pairs, np.int64)
    m = np.asarray(masses, dtype=np.float64).reshape(-1)
    invm = np.where(m > 0, 1.0 / np.maximum(m, 1e-12), 0.0)
    w = np.concatenate([-invm[pairs[:, 0]], invm[pairs[:, 1]]])[:, None]
    atoms, anchor = _cluster_anchors(pairs, m)
    return ConstraintSet(
        pairs=torch.as_tensor(pairs, device=device),
        r0=torch.as_tensor(np.asarray(r0, np.float64), dtype=dtype, device=device),
        invm=torch.as_tensor(invm.reshape(-1, 1), dtype=dtype, device=device),
        iterations=int(iterations), relax=float(relax),
        ij=torch.as_tensor(np.concatenate([pairs[:, 0], pairs[:, 1]]), device=device),
        wsign=torch.as_tensor(w, dtype=dtype, device=device),
        atoms=torch.as_tensor(atoms, device=device),
        anchor=torch.as_tensor(anchor, device=device))


def _cluster_anchors(pairs, masses):
    """(atoms, anchor): every atom of the constraint graph once, and for
    each the heaviest atom (lowest index on a tie) of its connected
    component, the cluster's heavy atom under 'hbonds'."""
    parent = {}

    def root(a):
        while parent.setdefault(a, a) != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for a, b in pairs:
        ra, rb = root(int(a)), root(int(b))
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    atoms = np.unique(pairs.reshape(-1))
    best = {}
    for a in atoms:
        r = root(int(a))
        if r not in best or masses[a] > masses[best[r]]:
            best[r] = int(a)
    return atoms, np.array([best[root(int(a))] for a in atoms], np.int64)


def _sweep_terms(cs: ConstraintSet, x):
    """(C, 3)-shaped i - j differences of `x` (one gather of 2C rows)."""
    c = cs.r0.shape[0]
    xx = x[..., cs.ij, :]
    return xx[..., :c, :] - xx[..., c:, :]


def _jacobi(cs: ConstraintSet, x, d, denom, residual):
    """`cs.iterations` Jacobi sweeps x_i -= k d_c w_i, x_j += k d_c w_j
    with k = relax * residual(x) / denom, on a copy of `x`."""
    x = x.clone()
    step = d * (cs.relax / denom)[..., None]
    step = torch.cat([step, step], dim=-2) * cs.wsign
    for _ in range(cs.iterations):
        r = residual(x)
        x.index_add_(-2, cs.ij, torch.cat([r, r], dim=-1)[..., None] * step)
    return x


def shake_positions(cs: ConstraintSet, pos_new, pos_ref):
    """Project `pos_new` back onto the constraint manifold, using the
    pre-step geometry `pos_ref` for the constraint gradients (standard
    SHAKE linearisation)."""
    ref = _sweep_terms(cs, pos_ref)
    i, j = cs.pairs[:, 0], cs.pairs[:, 1]
    denom = 2.0 * torch.linalg.vecdot(ref, ref) * (cs.invm[i] + cs.invm[j])[:, 0]
    r0sq = cs.r0 * cs.r0

    def residual(p):
        d = _sweep_terms(cs, p)
        return torch.linalg.vecdot(d, d) - r0sq

    return _jacobi(cs, pos_new, ref, denom, residual)


def rattle_velocities(cs: ConstraintSet, pos, vel):
    """Remove the velocity components along the constraints (RATTLE)."""
    d = _sweep_terms(cs, pos)
    i, j = cs.pairs[:, 0], cs.pairs[:, 1]
    denom = torch.linalg.vecdot(d, d) * (cs.invm[i] + cs.invm[j])[:, 0]

    def residual(v):
        return torch.linalg.vecdot(_sweep_terms(cs, v), d)

    return _jacobi(cs, vel, d, denom, residual)


def max_constraint_error(cs: ConstraintSet, pos):
    """Largest |distance - r0| over the SHAKE constraints."""
    d = torch.linalg.norm(_sweep_terms(cs, pos), dim=-1)
    return (d - cs.r0).abs().max()


class SettleSet(NamedTuple):
    oidx: torch.Tensor   # (W,) int64 oxygen
    h1: torch.Tensor     # (W,) int64
    h2: torch.Tensor     # (W,) int64
    m_o: torch.Tensor    # (W, 1)
    m_h: torch.Tensor    # (W, 1)
    ra: torch.Tensor     # (W,) canonical-triangle COM..O distance
    rb: torch.Tensor     # (W,) COM..HH-midline distance
    rc: torch.Tensor     # (W,) half H-H distance
    r_oh: torch.Tensor   # (W,)
    r_hh: torch.Tensor   # (W,)


class Constraints(NamedTuple):
    shake: Optional[ConstraintSet]
    settle: Optional[SettleSet]
    ncon: int


def _bond_tables(parameters):
    idx = np.asarray(parameters.bond_params["idx"])
    bmap = np.asarray(parameters.bond_params["map"])
    bpar = np.asarray(parameters.bond_params["params"])
    return idx, bpar[bmap[:, 1], 1]


def find_waters(parameters, h_mass_cut=H_MASS_CUT):
    """(W, 3) [O, H1, H2] index triplets of rigid-water candidates: a heavy
    atom bonded to exactly two light atoms (by the force field's masses)
    that have no other heavy bond. Returns (triplets, r_oh per water, r_hh
    per water) from the equilibrium bond lengths / H-O-H angle."""
    none = np.zeros((0, 3), np.int64), np.zeros(0), np.zeros(0)
    if parameters.bond_params is None:
        return none
    idx, r0_all = _bond_tables(parameters)
    light = _light(parameters, h_mass_cut)

    neigh: dict = {}
    bond_r0: dict = {}
    for (a, b), r0 in zip(idx, r0_all):
        a, b = int(a), int(b)
        neigh.setdefault(a, []).append(b)
        neigh.setdefault(b, []).append(a)
        bond_r0[(min(a, b), max(a, b))] = float(r0)

    # angle targets for r_HH via the law of cosines
    ang_theta: dict = {}
    if parameters.angle_params is not None:
        aidx = np.asarray(parameters.angle_params["idx"])
        amap = np.asarray(parameters.angle_params["map"])
        apar = np.asarray(parameters.angle_params["params"])
        for (a, b, c), th in zip(aidx, apar[amap[:, 1], 1]):
            ang_theta[(int(a), int(b), int(c))] = float(th)
            ang_theta[(int(c), int(b), int(a))] = float(th)

    waters, r_ohs, r_hhs = [], [], []
    for o, nb in neigh.items():
        if light[o]:
            continue
        hs = sorted(h for h in nb if light[h])
        if len(hs) != 2:
            continue
        h1, h2 = hs
        # hydrogens must belong to this water only
        if any(not light[x] and x != o for x in neigh.get(h1, []) + neigh.get(h2, [])):
            continue
        r1 = bond_r0.get((min(o, h1), max(o, h1)))
        r2 = bond_r0.get((min(o, h2), max(o, h2)))
        if r1 is None or r2 is None or abs(r1 - r2) > 1e-6:
            continue
        rhh = bond_r0.get((min(h1, h2), max(h1, h2)))
        if rhh is None:
            th = ang_theta.get((h1, o, h2))
            if th is None:
                continue
            rhh = float(np.sqrt(2.0 * r1 * r1 * (1.0 - np.cos(th))))
        waters.append((o, h1, h2))
        r_ohs.append(r1)
        r_hhs.append(rhh)
    if not waters:
        return none
    return np.asarray(waters, np.int64), np.asarray(r_ohs), np.asarray(r_hhs)


def build_settle(parameters, masses, h_mass_cut=H_MASS_CUT, device="cpu",
                 dtype=torch.float64) -> Optional[SettleSet]:
    """SETTLE for the rigid waters of `find_waters`, with the dynamical
    `masses`."""
    triplets, r_oh, r_hh = find_waters(parameters, h_mass_cut)
    if len(triplets) == 0:
        return None
    masses = np.asarray(masses, np.float64).reshape(-1)
    m_o = masses[triplets[:, 0]]
    m_h = masses[triplets[:, 1]]
    rc = 0.5 * r_hh
    t1 = np.sqrt(np.maximum(r_oh**2 - rc**2, 1e-12))  # O..HH-midline
    ra = t1 * 2.0 * m_h / (m_o + 2.0 * m_h)

    def f(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    def i(a):
        return torch.as_tensor(a, dtype=torch.int64, device=device)

    return SettleSet(oidx=i(triplets[:, 0]), h1=i(triplets[:, 1]),
                     h2=i(triplets[:, 2]), m_o=f(m_o[:, None]),
                     m_h=f(m_h[:, None]), ra=f(ra), rb=f(t1 - ra), rc=f(rc),
                     r_oh=f(r_oh), r_hh=f(r_hh))


def _unit_rows(v):
    return v / torch.sqrt(torch.clamp((v * v).sum(-1, keepdim=True), min=1e-32))


def _dot(a, b):
    return (a * b).sum(-1)


def _rows(x, idx):
    return x[..., idx, :]


def _write3(x, ss: SettleSet, o, h1, h2):
    x = x.clone()
    x[..., ss.oidx, :] = o.to(x.dtype)
    x[..., ss.h1, :] = h1.to(x.dtype)
    x[..., ss.h2, :] = h2.to(x.dtype)
    return x


def settle_positions(ss: SettleSet, pos_new, pos_ref):
    """Analytic position constraint for rigid 3-site waters: places each
    water's target triangle so that COM and angular momentum match the
    unconstrained update (Miyamoto & Kollman 1992)."""
    mO, mH = ss.m_o, ss.m_h
    refO, refH1, refH2 = (_rows(pos_ref, k) for k in (ss.oidx, ss.h1, ss.h2))
    newO, newH1, newH2 = (_rows(pos_new, k) for k in (ss.oidx, ss.h1, ss.h2))
    b0 = refH1 - refO
    c0 = refH2 - refO
    com = (newO * mO + (newH1 + newH2) * mH) / (mO + 2.0 * mH)
    a1, b1, c1 = newO - com, newH1 - com, newH2 - com

    # primed frame: z' = old-plane normal, x' ~ cross(a1, z'), y' completes
    zax = _unit_rows(torch.linalg.cross(b0, c0, dim=-1))
    xax = _unit_rows(torch.linalg.cross(a1, zax, dim=-1))
    yax = torch.linalg.cross(zax, xax, dim=-1)

    def prime(v):
        return _dot(v, xax), _dot(v, yax), _dot(v, zax)

    B0x, B0y, _ = prime(b0)
    C0x, C0y, _ = prime(c0)
    _, _, A1z = prime(a1)
    B1x, B1y, B1z = prime(b1)
    C1x, C1y, C1z = prime(c1)

    ra, rb, rc = ss.ra, ss.rb, ss.rc
    sinphi = torch.clamp(A1z / ra, -1.0, 1.0)
    cosphi = torch.sqrt(torch.clamp(1.0 - sinphi**2, min=1e-12))
    sinpsi = torch.clamp((B1z - C1z) / (2.0 * rc * cosphi), -1.0, 1.0)
    cospsi = torch.sqrt(torch.clamp(1.0 - sinpsi**2, min=0.0))

    ya2 = ra * cosphi
    xb2 = -rc * cospsi
    yb2 = -rb * cosphi - rc * sinpsi * sinphi
    yc2 = -rb * cosphi + rc * sinpsi * sinphi

    alpha = xb2 * (B0x - C0x) + B0y * yb2 + C0y * yc2
    beta = xb2 * (C0y - B0y) + B0x * yb2 + C0x * yc2
    gamma = B0x * B1y - B1x * B0y + C0x * C1y - C1x * C0y
    a2b2 = alpha**2 + beta**2
    sinth = torch.clamp(
        (alpha * gamma - beta * torch.sqrt(torch.clamp(a2b2 - gamma**2, min=0.0)))
        / torch.clamp(a2b2, min=1e-32), -1.0, 1.0)
    costh = torch.sqrt(torch.clamp(1.0 - sinth**2, min=0.0))

    xa3, ya3, za3 = -ya2 * sinth, ya2 * costh, ra * sinphi
    xb3 = xb2 * costh - yb2 * sinth
    yb3 = xb2 * sinth + yb2 * costh
    zb3 = -rb * sinphi + rc * sinpsi * cosphi
    xc3 = -xb2 * costh - yc2 * sinth
    yc3 = -xb2 * sinth + yc2 * costh
    zc3 = -rb * sinphi - rc * sinpsi * cosphi

    def unprime(x, y, z):
        return x[..., None] * xax + y[..., None] * yax + z[..., None] * zax + com

    return _write3(pos_new, ss, unprime(xa3, ya3, za3), unprime(xb3, yb3, zb3),
                   unprime(xc3, yc3, zc3))


def settle_velocities(ss: SettleSet, pos, vel):
    """Exact velocity constraint for rigid waters: the 3x3 RATTLE system
    per molecule (constraints O-H1, O-H2, H1-H2), solved in adjugate form."""
    invO = 1.0 / ss.m_o[:, 0]
    invH = 1.0 / ss.m_h[:, 0]
    posO, posH1, posH2 = (_rows(pos, k) for k in (ss.oidx, ss.h1, ss.h2))
    velO, velH1, velH2 = (_rows(vel, k) for k in (ss.oidx, ss.h1, ss.h2))
    e0 = _unit_rows(posO - posH1)        # constraint 0: (O, H1)
    e1 = _unit_rows(posO - posH2)        # constraint 1: (O, H2)
    e2 = _unit_rows(posH1 - posH2)       # constraint 2: (H1, H2)

    d0 = _dot(velO - velH1, e0)
    d1 = _dot(velO - velH2, e1)
    d2 = _dot(velH1 - velH2, e2)
    dot01, dot02, dot12 = _dot(e0, e1), _dot(e0, e2), _dot(e1, e2)

    # symmetric positive definite mass-metric Gram matrix: det > 0
    a00 = a11 = invO + invH
    a01 = invO * dot01
    a02 = -invH * dot02
    a12 = invH * dot12
    a22 = 2.0 * invH
    c00 = a11 * a22 - a12 * a12
    c01 = a02 * a12 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c11 = a00 * a22 - a02 * a02
    c12 = a01 * a02 - a00 * a12
    c22 = a00 * a11 - a01 * a01
    inv_det = 1.0 / (a00 * c00 + a01 * c01 + a02 * c02)
    lam0 = ((c00 * d0 + c01 * d1 + c02 * d2) * inv_det)[..., None]
    lam1 = ((c01 * d0 + c11 * d1 + c12 * d2) * inv_det)[..., None]
    lam2 = ((c02 * d0 + c12 * d1 + c22 * d2) * inv_det)[..., None]

    dO = -(lam0 * e0 + lam1 * e1) * invO[:, None]
    dH1 = (lam0 * e0 - lam2 * e2) * invH[:, None]
    dH2 = (lam1 * e1 + lam2 * e2) * invH[:, None]
    return _write3(vel, ss, velO + dO, velH1 + dH1, velH2 + dH2)


def max_settle_error(ss: SettleSet, pos):
    """Largest |distance - target| over the O-H1, O-H2 and H1-H2 bonds."""
    posO, posH1, posH2 = (_rows(pos, k) for k in (ss.oidx, ss.h1, ss.h2))
    errs = [(torch.linalg.norm(a - b, dim=-1) - r).abs().max()
            for a, b, r in ((posO, posH1, ss.r_oh), (posO, posH2, ss.r_oh),
                            (posH1, posH2, ss.r_hh))]
    return torch.stack(errs).max()


def build_constraint_spec(parameters, masses, mode="hbonds", iterations=50,
                          relax=0.5, h_mass_cut=H_MASS_CUT, device="cpu",
                          dtype=torch.float64) -> Optional[Constraints]:
    """mode: 'hbonds' | 'allbonds' (SHAKE/RATTLE) | 'settle' (analytic
    rigid waters and SHAKE on the remaining hydrogen bonds). `masses` are
    the dynamical masses. `ncon` counts SHAKE pairs and three per water."""
    if mode in (None, "none", False):
        return None
    ss = None
    if mode == "settle":
        ss = build_settle(parameters, masses, h_mass_cut, device=device, dtype=dtype)
    pairs, r0 = _constrained_bonds(parameters, "hbonds" if mode == "settle" else mode,
                                   h_mass_cut)
    if ss is not None and len(pairs):
        # SHAKE only the hydrogen bonds that are not part of a rigid water
        win = np.zeros(len(np.asarray(parameters.masses).reshape(-1)), bool)
        for k in (ss.oidx, ss.h1, ss.h2):
            win[k.cpu().numpy()] = True
        keep = ~(win[pairs[:, 0]] & win[pairs[:, 1]])
        pairs, r0 = pairs[keep], r0[keep]
    cs = _constraint_set(pairs, r0, masses, iterations, relax, device, dtype)
    if ss is None and cs is None:
        return None
    ncon = (0 if cs is None else int(cs.pairs.shape[0])) + (
        0 if ss is None else 3 * int(ss.oidx.shape[0]))
    return Constraints(shake=cs, settle=ss, ncon=ncon)


def apply_position_constraints(c: Constraints, pos_new, pos_ref):
    if c.shake is not None:
        pos_new = shake_positions(c.shake, pos_new, pos_ref)
    if c.settle is not None:
        pos_new = settle_positions(c.settle, pos_new, pos_ref)
    return pos_new


def apply_velocity_constraints(c: Constraints, pos, vel):
    if c.shake is not None:
        vel = rattle_velocities(c.shake, pos, vel)
    if c.settle is not None:
        vel = settle_velocities(c.settle, pos, vel)
    return vel


def repartition_hydrogen_masses(masses, bonds, factor=4.0, h_mass_cut=H_MASS_CUT):
    """Hydrogen mass repartitioning: scale each hydrogen's mass by `factor`
    and take the added mass from its bonded heavy atom. The total mass
    (and equilibrium thermodynamics) are unchanged; the fastest vibrations
    slow down, which with constrained hydrogen bonds allows 4 fs steps.
    Returns a new masses array; give it to the System (`set_masses`), not
    to the parameters, whose masses say which atoms are hydrogens."""
    m = np.asarray(masses, np.float64).reshape(-1).copy()
    light = m <= h_mass_cut
    added = m * (factor - 1.0)
    for a, b in np.asarray(bonds, np.int64).reshape(-1, 2):
        a, b = int(a), int(b)
        if light[a] and not light[b]:
            m[b] -= added[a]
        elif light[b] and not light[a]:
            m[a] -= added[b]
    m[light] *= factor
    if np.any(m <= 0):
        raise ValueError(
            "HMR factor too large: a heavy atom's mass went non-positive")
    return m


def constraint_virial(c: Constraints, masses, delta, drift, pos):
    """Per-axis virial sum_i f_i,a r_i,a of the position constraint forces
    f = 2 m delta / drift^2 (the MTK barostat's; drift (R, 1, 3)) of
    SETTLE and SHAKE, with each water's hydrogens taken relative to its
    oxygen and each SHAKE cluster's atoms relative to its heaviest atom:
    the forces of one water or one cluster sum to zero, so this equals
    the sum over absolute positions (the JAX scans' form), without that
    sum's f32 cancellation (absolute coordinates up to the box edge times
    forces that cancel within each cluster)."""
    f = 2.0 * masses * delta / (drift * drift)
    vir = torch.zeros_like(pos[..., 0, :])
    ss, cs = c.settle, c.shake
    if ss is not None:
        o = _rows(pos, ss.oidx)
        for h in (ss.h1, ss.h2):
            vir = vir + (_rows(f, h) * (_rows(pos, h) - o)).sum(-2)
    if cs is not None:
        vir = vir + (_rows(f, cs.atoms)
                     * (_rows(pos, cs.atoms) - _rows(pos, cs.anchor))).sum(-2)
    return vir
