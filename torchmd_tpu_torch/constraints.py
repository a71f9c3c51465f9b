"""Rigid-water constraints (SETTLE) on torch tensors.

Counterpart of the SETTLE part of `torchmd_tpu.constraints`: analytic
position constraints for rigid 3-site waters (Miyamoto & Kollman 1992) and
the exact 3x3 RATTLE velocity solve, in the gather form (rows picked by
index, written back out of place). Every function works on
(..., natoms, 3) tensors, so a leading replica axis passes through.

`build_constraint_spec` accepts mode="settle" for systems whose only
light-atom bonds sit inside rigid waters. SHAKE/RATTLE (the "hbonds" and
"allbonds" modes, and hydrogen bonds outside waters under "settle") come
with a later slice of the port and raise NotImplementedError.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


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
    settle: Optional[SettleSet]
    ncon: int


def _bond_tables(parameters):
    idx = np.asarray(parameters.bond_params["idx"])
    bmap = np.asarray(parameters.bond_params["map"])
    bpar = np.asarray(parameters.bond_params["params"])
    return idx, bpar[bmap[:, 1], 1]


def find_waters(parameters, masses, h_mass_cut=3.5):
    """(W, 3) [O, H1, H2] index triplets of rigid-water candidates: a heavy
    atom bonded to exactly two light atoms that have no other heavy bond.
    Returns (triplets, r_oh per water, r_hh per water) from the equilibrium
    bond lengths / H-O-H angle."""
    none = np.zeros((0, 3), np.int64), np.zeros(0), np.zeros(0)
    if parameters.bond_params is None:
        return none
    idx, r0_all = _bond_tables(parameters)
    light = np.asarray(masses, np.float64).reshape(-1) <= h_mass_cut

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


def build_settle(parameters, masses, h_mass_cut=3.5, device="cpu",
                 dtype=torch.float64) -> Optional[SettleSet]:
    triplets, r_oh, r_hh = find_waters(parameters, masses, h_mass_cut)
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


def build_constraint_spec(parameters, masses, mode="settle", device="cpu",
                          dtype=torch.float64) -> Optional[Constraints]:
    """mode 'settle': analytic rigid waters. Hydrogen bonds outside rigid
    waters (SHAKE) and the 'hbonds'/'allbonds' modes raise
    NotImplementedError."""
    if mode in (None, "none", False):
        return None
    if mode != "settle":
        raise NotImplementedError(
            f"constraints={mode!r} (SHAKE/RATTLE) is not ported yet; a later "
            "slice of the port brings it")
    ss = build_settle(parameters, masses, device=device, dtype=dtype)
    if parameters.bond_params is not None:
        idx, _ = _bond_tables(parameters)
        light = np.asarray(masses, np.float64).reshape(-1) <= 3.5
        in_water = np.zeros(len(light), bool)
        if ss is not None:
            for k in (ss.oidx, ss.h1, ss.h2):
                in_water[k.cpu().numpy()] = True
        hbond = light[idx[:, 0]] | light[idx[:, 1]]
        if np.any(hbond & ~(in_water[idx[:, 0]] & in_water[idx[:, 1]])):
            raise NotImplementedError(
                "hydrogen bonds outside rigid waters need SHAKE, which is not "
                "ported yet; a later slice of the port brings it")
    if ss is None:
        return None
    return Constraints(settle=ss, ncon=3 * int(ss.oidx.shape[0]))


def apply_position_constraints(c: Constraints, pos_new, pos_ref):
    return settle_positions(c.settle, pos_new, pos_ref)


def apply_velocity_constraints(c: Constraints, pos, vel):
    return settle_velocities(c.settle, pos, vel)


def constraint_virial(c: Constraints, masses, delta, drift, pos):
    """Per-axis virial sum_i f_i,a r_i,a of the position constraint's
    forces f = 2 m delta / drift^2 (the MTK barostat's; drift (R, 1, 3)),
    with each water's hydrogens taken relative to its oxygen: the forces
    of one water sum to zero, so this equals the sum over absolute
    positions, without that sum's f32 cancellation (absolute coordinates
    up to the box edge times forces that cancel within each water)."""
    f = 2.0 * masses * delta / (drift * drift)
    ss = c.settle
    o = _rows(pos, ss.oidx)
    return sum((_rows(f, h) * (_rows(pos, h) - o)).sum(-2) for h in (ss.h1, ss.h2))
