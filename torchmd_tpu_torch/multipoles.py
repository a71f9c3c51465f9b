"""Permanent point dipoles and quadrupoles with AMOEBA-style local frames,
the port of `torchmd_tpu.multipoles`.

Each site carries a permanent dipole (and optionally a traceless
quadrupole, Jackson convention Q_ab = sum q (3 r_a r_b - r^2 d_ab))
defined in a LOCAL frame built from its bonded neighbours (z-then-x or
bisector, Ren & Ponder, J. Phys. Chem. B 107, 5933 (2003)), rotated into
the lab frame at every evaluation. Interactions, r_ij = r_j - r_i:

    charge-dipole   E = EF q_j mu_i . r_ij / r^3
    dipole-dipole   E = EF [mu_i.mu_j - 3 (mu_i.r^)(mu_j.r^)] / r^3
    quadrupole      phi_Q(r) = EF (r^T Q r) / (2 r^5) at r from the site:
                    charge q_j phi_Q, dipole mu_j . grad phi_Q,
                    quadrupole (1/6) Q_j : hess phi_Q

over the nonbonded pair mask, minimum-image wrapped, optionally cut off
with the LJ switch's cubic taper. The JAX package takes grad phi_Q and
hess phi_Q by nested AD; here they are written out in closed form. The
energy is one function of the positions, frames included, so
`torch.autograd` gives forces with the frame torques on the
frame-defining atoms. `Multipoles` is an external potential
(`Forces(external=...)`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .external import TorchExternal
from .potentials import wrap_displacement
from .systems import resolve_device
from .units import ELEC_FACTOR

FRAME_NONE = 0       # lab frame (fixed dipole vector)
FRAME_Z_THEN_X = 1   # z toward atom z_i; x toward x_i, orthogonalized
FRAME_BISECTOR = 2   # z along the bisector of (z_i, x_i); x in-plane


class MultipoleSpec(NamedTuple):
    sites: torch.Tensor       # (ns,) int64 atom rows carrying dipoles
    mu_local: torch.Tensor    # (ns, 3) float64 local-frame dipoles
    frame_kind: torch.Tensor  # (ns,) int64 FRAME_* code
    z_atom: torch.Tensor      # (ns,) int64 frame-defining neighbour (or site)
    x_atom: torch.Tensor      # (ns,) int64 second neighbour (or site)
    nb_mask: torch.Tensor     # (natoms, natoms) bool nonbonded pair mask
    cutoff: Optional[float]
    quad_local: Optional[torch.Tensor] = None   # (ns, 3, 3) float64, traceless
    switch_dist: Optional[float] = None


def make_multipoles(ffparams, dipoles, cutoff=None, switch_dist=None,
                    charges=None, device=None):
    """Build a `Multipoles` evaluator (the JAX `make_multipoles`).

    dipoles: dicts with keys atom, mu (local frame, e*A), frame ('none' |
    'z-then-x' | 'bisector'), z (unless frame='none'), x, quad (optional
    3x3 traceless local quadrupole, e*A^2, Jackson convention). The
    exclusions come from `ffparams.nb_mask`; `charges` (default
    `ffparams.charges`) feed the charge-dipole and charge-quadrupole
    tiers. Runs on the card unless given `device`."""
    if ffparams.nb_mask is None:
        raise ValueError("multipoles need the dense nonbonded mask")
    if switch_dist is not None and cutoff is None:
        raise ValueError("switch_dist needs a cutoff")
    device = resolve_device(device)
    kinds = {"none": FRAME_NONE, "z-then-x": FRAME_Z_THEN_X,
             "bisector": FRAME_BISECTOR}
    sites, mus, fks, za, xa, quads = [], [], [], [], [], []
    any_quad = False
    for d in dipoles:
        a = int(d["atom"])
        k = kinds[d.get("frame", "none")]
        if k != FRAME_NONE and "z" not in d:
            raise ValueError(f"site {a}: frame needs a z atom")
        if k == FRAME_BISECTOR and "x" not in d:
            raise ValueError(f"site {a}: bisector frame needs z and x")
        mu = np.asarray(d.get("mu", [0.0, 0.0, 0.0]), np.float64).reshape(3)
        Q = np.asarray(d.get("quad", np.zeros((3, 3))), np.float64).reshape(3, 3)
        if k == FRAME_Z_THEN_X and "x" not in d:
            # without an x atom only axially symmetric moments are defined
            axial_mu = abs(mu[0]) < 1e-12 and abs(mu[1]) < 1e-12
            axial_q = (abs(Q[0, 0] - Q[1, 1]) < 1e-12 and abs(Q[0, 1]) < 1e-12
                       and abs(Q[0, 2]) < 1e-12 and abs(Q[1, 2]) < 1e-12)
            if not (axial_mu and axial_q):
                raise ValueError(f"site {a}: z-then-x frame with transverse moment "
                                 "components needs an x atom")
        if not np.allclose(Q, Q.T):
            raise ValueError(f"site {a}: quadrupole must be symmetric")
        if abs(np.trace(Q)) > 1e-10 * max(1.0, np.abs(Q).max()):
            raise ValueError(f"site {a}: quadrupole must be traceless")
        any_quad = any_quad or bool(np.any(Q != 0))
        sites.append(a)
        mus.append(mu)
        fks.append(k)
        za.append(int(d.get("z", a)))
        xa.append(int(d.get("x", d.get("z", a))))
        quads.append(Q)

    def ints(v):
        return torch.as_tensor(np.asarray(v, np.int64), device=device)

    spec = MultipoleSpec(
        sites=ints(sites), mu_local=torch.as_tensor(np.stack(mus), device=device),
        frame_kind=ints(fks), z_atom=ints(za), x_atom=ints(xa),
        nb_mask=torch.as_tensor(np.asarray(_to_numpy(ffparams.nb_mask), bool),
                                device=device),
        cutoff=None if cutoff is None else float(cutoff),
        quad_local=(torch.as_tensor(np.stack(quads), device=device)
                    if any_quad else None),
        switch_dist=None if switch_dist is None else float(switch_dist))
    q = ffparams.charges if charges is None else charges
    return Multipoles(spec, q, device=device)


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _normalize(v, eps=1e-12):
    return v / torch.sqrt((v * v).sum(-1, keepdim=True) + eps)


def lab_frames(spec: MultipoleSpec, pos, box):
    """Local -> lab rotation matrices R (ns, 3, 3), columns (ex, ey, ez)."""
    p_s = pos.index_select(0, spec.sites)
    vz = wrap_displacement(pos.index_select(0, spec.z_atom) - p_s, box)
    vx = wrap_displacement(pos.index_select(0, spec.x_atom) - p_s, box)
    kind = spec.frame_kind[:, None]
    ez = torch.where(kind == FRAME_BISECTOR, _normalize(_normalize(vz) + _normalize(vx)),
                     _normalize(vz))
    # x axis: vx orthogonalized against z (any perpendicular when vx is
    # degenerate or absent)
    perp = torch.stack([ez[:, 1] - ez[:, 2], ez[:, 2] - ez[:, 0], ez[:, 0] - ez[:, 1]], -1)
    vx_eff = torch.where((vx * vx).sum(-1, keepdim=True) > 1e-12, vx, perp)
    ex = _normalize(vx_eff - (vx_eff * ez).sum(-1, keepdim=True) * ez)
    ey = torch.linalg.cross(ez, ex, dim=-1)
    return torch.stack([ex, ey, ez], dim=-1)


def lab_dipoles(spec: MultipoleSpec, pos, box):
    """Local dipoles rotated into the lab frame: (ns, 3)."""
    mu = spec.mu_local.to(pos.dtype)
    mu_lab = torch.einsum("sab,sb->sa", lab_frames(spec, pos, box), mu)
    return torch.where(spec.frame_kind[:, None] == FRAME_NONE, mu, mu_lab)


def lab_quadrupoles(spec: MultipoleSpec, pos, box):
    """Local traceless quadrupoles rotated into the lab: (ns, 3, 3)."""
    R = lab_frames(spec, pos, box)
    Q = spec.quad_local.to(pos.dtype)
    Q_lab = torch.einsum("sab,sbc,sdc->sad", R, Q, R)
    return torch.where(spec.frame_kind[:, None, None] == FRAME_NONE, Q, Q_lab)


def parse_tinker_multipoles(text):
    """TINKER/AMOEBA `multipole` records -> {atom_type: {"monopole",
    "dipole" (3,), "quad" (3, 3) symmetric, "frame" ('z-then-x' |
    'bisector' | 'none'), "z_type", "x_type"}}, values verbatim in the
    file's units (e*Bohr, e*Bohr^2). Negative z and x types mean a
    bisector frame, a zero z type no frame."""
    out = {}
    lines = [ln.split("#")[0].rstrip() for ln in text.splitlines()]
    i = 0
    while i < len(lines):
        parts = lines[i].split()
        if not parts or parts[0].lower() != "multipole":
            i += 1
            continue
        head = [float(x) for x in parts[1:]]
        axes = [int(x) for x in head[:-1]]
        k = axes[0]
        z_t = axes[1] if len(axes) > 1 else 0
        x_t = axes[2] if len(axes) > 2 else 0
        if z_t < 0 and x_t < 0:
            frame = "bisector"
        elif z_t == 0:
            frame = "none"
        else:
            frame = "z-then-x"
        dip = [float(x) for x in lines[i + 1].split()]
        qxx = [float(x) for x in lines[i + 2].split()]
        qxy = [float(x) for x in lines[i + 3].split()]
        qxz = [float(x) for x in lines[i + 4].split()]
        Q = np.array([[qxx[0], qxy[0], qxz[0]],
                      [qxy[0], qxy[1], qxz[1]],
                      [qxz[0], qxz[1], qxz[2]]])
        out[k] = {"monopole": head[-1], "dipole": np.asarray(dip), "quad": Q,
                  "frame": frame, "z_type": abs(z_t), "x_type": abs(x_t)}
        i += 5
    return out


def _switch_factor(d2, cutoff, switch_dist):
    """Cubic taper (the LJ switch's polynomial) on r in [switch_dist,
    cutoff]: 1 below, continuous to 0 at the cutoff."""
    if switch_dist is None or cutoff is None:
        return 1.0
    t = torch.clamp((torch.sqrt(d2) - switch_dist) / (cutoff - switch_dist), 0.0, 1.0)
    return 1.0 + t * t * t * (-10.0 + t * (15.0 - t * 6.0))


class BatchedExternal:
    """The batched host protocol `calculate(pos (R, N, 3), box)` of the
    reference (torchmd/forces.py:321-326) for an external with
    `energy_fn`: `external.TorchExternal.calculate`, the box optional."""

    def calculate(self, pos, box=None):
        return TorchExternal.calculate(self, pos, box)


class Multipoles(BatchedExternal):
    """External potential of permanent point dipoles and quadrupoles."""

    def __init__(self, spec: MultipoleSpec, charges, device=None):
        self.spec = spec
        self.device = spec.sites.device if device is None else torch.device(device)
        self.charges = torch.as_tensor(np.asarray(_to_numpy(charges), np.float64),
                                       device=self.device)
        s = spec.sites
        self._mask_sa = spec.nb_mask[s]                    # (ns, natoms)
        ns = int(s.shape[0])
        upper = torch.triu(torch.ones(ns, ns, dtype=torch.bool, device=self.device), 1)
        self._mask_ss = spec.nb_mask[s[:, None], s[None, :]]
        self._mask_ss_once = self._mask_ss & upper

    def _cut(self, mask, d2):
        if self.spec.cutoff is not None:
            mask = mask & (d2 <= self.spec.cutoff ** 2)
        return mask

    def energy_fn(self, pos, box=None):
        spec = self.spec
        q = self.charges.to(pos.dtype)
        mu = lab_dipoles(spec, pos, box)
        s = spec.sites
        zero = torch.zeros((), dtype=pos.dtype, device=pos.device)

        def sw(d2):
            return _switch_factor(d2, spec.cutoff, spec.switch_dist)

        # charge-dipole over every (site, atom) pair the mask allows
        dv = wrap_displacement(pos[None, :, :] - pos[s][:, None, :], box)
        d2 = (dv * dv).sum(-1)
        m_qd = self._cut(self._mask_sa, d2)
        d2s = torch.where(m_qd, d2, torch.ones_like(d2))
        inv_r3 = d2s ** -1.5
        mudotr = (mu[:, None, :] * dv).sum(-1)
        e = torch.where(m_qd, ELEC_FACTOR * q[None, :] * mudotr * inv_r3 * sw(d2s),
                        zero).sum()

        # dipole-dipole over site pairs, each once
        dss = wrap_displacement(pos[s][None, :, :] - pos[s][:, None, :], box)
        d2ss = (dss * dss).sum(-1)
        m_dd = self._cut(self._mask_ss_once, d2ss)
        d2s = torch.where(m_dd, d2ss, torch.ones_like(d2ss))
        inv_r3 = d2s ** -1.5
        inv_r5 = inv_r3 / d2s
        mimj = (mu[:, None, :] * mu[None, :, :]).sum(-1)
        mir = (mu[:, None, :] * dss).sum(-1)
        mjr = (mu[None, :, :] * dss).sum(-1)
        e = e + torch.where(
            m_dd, ELEC_FACTOR * (mimj * inv_r3 - 3.0 * mir * mjr * inv_r5) * sw(d2s),
            zero).sum()

        if spec.quad_local is not None:
            # phi_Q(r) = EF (r Q r) / (2 r^5) of the quadrupole at site i,
            # its gradient and Hessian in closed form
            Qs = lab_quadrupoles(spec, pos, box)
            one = torch.ones_like(dv)
            rq = torch.where(m_qd[..., None], dv, one)  # m_qd: the (site, atom) mask
            r2 = (rq * rq).sum(-1)
            rQr = torch.einsum("sna,sab,snb->sn", rq, Qs, rq)
            phi = 0.5 * ELEC_FACTOR * rQr * r2 ** -2.5
            e = e + torch.where(m_qd, q[None, :] * phi * sw(r2), zero).sum()

            m_ss = self._cut(self._mask_ss, d2ss)
            r = torch.where(m_ss[..., None], dss, torch.ones_like(dss))
            r2 = (r * r).sum(-1)
            inv5 = r2 ** -2.5
            inv7 = inv5 / r2
            Qr = torch.einsum("iab,ijb->ija", Qs, r)           # Q_i r_ij
            rQr = (Qr * r).sum(-1)
            grad = ELEC_FACTOR * (Qr * inv5[..., None]
                                  - 2.5 * (rQr * inv7)[..., None] * r)
            sw_ss = sw(r2)
            e = e + torch.where(m_ss, (mu[None, :, :] * grad).sum(-1) * sw_ss, zero).sum()
            # Q_j : hess phi_Qi(r_ij)
            QjR = torch.einsum("jab,ijb->ija", Qs, r)          # Q_j r_ij
            QQ = torch.einsum("iab,jab->ij", Qs, Qs)
            trj = torch.diagonal(Qs, dim1=1, dim2=2).sum(-1)[None, :]
            rQjr = (QjR * r).sum(-1)
            hess = ELEC_FACTOR * (QQ * inv5 - 10.0 * (Qr * QjR).sum(-1) * inv7
                                  - 2.5 * rQr * trj * inv7
                                  + 17.5 * rQr * rQjr * inv7 / r2)
            m_once = m_ss & self._mask_ss_once
            e = e + torch.where(m_once, hess / 6.0 * sw_ss, zero).sum()
        return e
