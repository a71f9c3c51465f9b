"""Massless virtual interaction sites (TIP4P/TIP5P-family waters, GROMACS
[virtual_sitesN]) on torch tensors.

Counterpart of `torchmd_tpu.vsites`: a virtual site is a massless charge/LJ
centre whose position is a function of its host atoms' positions.
`apply_vsites` snaps the site rows of a position tensor; the site forces
move onto the hosts with the exact chain rule J^T f (`spread_vsite_forces`):
analytically where every site is a fixed linear combination of its hosts
(kinds (2, 1) and (3, 1), TIP4P's M site), by autograd of the
reconstruction otherwise.

Supported constructions (GROMACS manual ch. 5.5; codes = (nhosts, funct)):
  (2, 1) linear:          r = (1-a) r_i + a r_j
  (2, 2) fixed distance:  r = r_i + a * unit(r_j - r_i)
  (3, 1) linear (TIP4P):  r = (1-a-b) r_i + a r_j + b r_k
  (3, 2) fixed distance:  r = r_i + d * unit(r_ij + a r_jk)
  (3, 3) fixed angle:     r = r_i + d cos(th) u1 + d sin(th) u2
  (3, 4) out-of-plane:    r = r_i + a r_ij + b r_ik + c (r_ij x r_ik)
  (4, 2) 4fdn:            r = r_i + c * unit((a r_ik - r_ij) x (b r_il - r_ij))
Parameters are stored pre-converted to Angstrom units. Every function
works on (..., natoms, 3) positions, so a leading replica axis passes
through.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .potentials import wrap_displacement

LINEAR_KINDS = ((2, 1), (3, 1))


class VSiteGroup(NamedTuple):
    """One batch of virtual sites sharing a construction kind."""

    kind: tuple            # (nhosts, funct)
    sites: torch.Tensor    # (s,) int64 site atom rows
    hosts: torch.Tensor    # (s, 4) int64 host atom rows (unused repeat)
    params: torch.Tensor   # (s, 3) float, Angstrom units


def _tensor(a, dtype, device):
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def vsite_groups_to(groups, device, dtype):
    """The groups (this module's, or any with array-like `sites`, `hosts`,
    `params` fields, such as the JAX package's) as VSiteGroups with
    indices on `device` and parameters at `dtype`."""
    return tuple(VSiteGroup(kind=tuple(int(k) for k in g.kind),
                            sites=_tensor(g.sites, torch.int64, device),
                            hosts=_tensor(g.hosts, torch.int64, device),
                            params=_tensor(g.params, dtype, device))
                 for g in groups)


def _unit(v):
    return v / torch.sqrt(torch.clamp((v * v).sum(-1, keepdim=True), min=1e-24))


def _group_positions(g: VSiteGroup, pos, box):
    ri = pos[..., g.hosts[:, 0], :]
    rij = wrap_displacement(pos[..., g.hosts[:, 1], :] - ri, box)
    a, b, c = g.params[:, 0:1], g.params[:, 1:2], g.params[:, 2:3]
    kind = g.kind
    if kind == (2, 1):
        return ri + a * rij
    if kind == (2, 2):
        return ri + a * _unit(rij)
    rik = wrap_displacement(pos[..., g.hosts[:, 2], :] - ri, box)
    if kind == (3, 1):
        return ri + a * rij + b * rik
    if kind == (3, 2):
        # b = d [A]; direction r_ij + a * r_jk
        return ri + b * _unit(rij + a * (rik - rij))
    if kind == (3, 3):
        # a = theta [rad], b = d [A]
        u1 = _unit(rij)
        rjk = rik - rij
        u2 = _unit(rjk - (rjk * u1).sum(-1, keepdim=True) * u1)
        return ri + b * (torch.cos(a) * u1 + torch.sin(a) * u2)
    if kind == (3, 4):
        return ri + a * rij + b * rik + c * torch.linalg.cross(rij, rik, dim=-1)
    if kind == (4, 2):
        ril = wrap_displacement(pos[..., g.hosts[:, 3], :] - ri, box)
        return ri + c * _unit(torch.linalg.cross(a * rik - rij, b * ril - rij,
                                                 dim=-1))
    raise NotImplementedError(f"virtual-site kind {kind}")


def apply_vsites(groups, pos, box=None):
    """`pos` with every virtual-site row snapped onto its reconstructed
    position (out of place, differentiable)."""
    for g in groups:
        pos = pos.index_copy(pos.dim() - 2, g.sites,
                             _group_positions(g, pos, box).to(pos.dtype))
    return pos


def apply_vsites_scaling(groups, pos, box):
    """(snapped positions, their derivative along a uniform scaling of
    positions and box): one forward-mode pass of `apply_vsites` with
    tangents (pos, box). Host rows give the tangent pos itself; a site's
    fixed-length offsets do not scale with the box."""
    return torch.func.jvp(lambda p, b: apply_vsites(groups, p, b),
                          (pos, box), (pos, box))


def _linear_coefficients(g: VSiteGroup):
    """Per-host weights of a linear site: r_site = sum_h w_h r_h."""
    a, b = g.params[:, 0], g.params[:, 1]
    if g.kind == (2, 1):
        return (1.0 - a, a)
    return (1.0 - a - b, a, b)


def spread_vsite_forces(groups, pos, forces, box=None):
    """Transfer the site rows of `forces` onto the hosts (exact J^T f of
    `apply_vsites` at `pos`) and zero the site rows."""
    if any(g.kind not in LINEAR_KINDS for g in groups):
        with torch.enable_grad():
            p = pos.detach().requires_grad_(True)
            (out,) = torch.autograd.grad(apply_vsites(groups, p, box), p, forces)
        return out
    axis = forces.dim() - 2
    out = forces.clone()
    for g in reversed(groups):  # the adjoint of the sequential snap
        f_site = out.index_select(axis, g.sites)
        out.index_fill_(axis, g.sites, 0.0)
        for h, w in enumerate(_linear_coefficients(g)):
            out.index_add_(axis, g.hosts[:, h], w[:, None].to(out.dtype) * f_site)
    return out


def wrap_energy_forces(groups, ef):
    """Wrap a (pos, box, *args) -> (pot, forces) evaluator: evaluate at
    the reconstructed geometry and spread site forces to hosts."""

    def wrapped(pos, box, *args):
        # R conformations' (R, 3) boxes broadcast over the atom axis
        vbox = box[:, None] if box is not None and pos.dim() == 3 else box
        pot, frc = ef(apply_vsites(groups, pos, vbox), box, *args)
        return pot, spread_vsite_forces(groups, pos, frc, vbox)

    return wrapped


# ----------------------------------------------------------------------
# Construction from GROMACS topologies
# ----------------------------------------------------------------------

def build_vsite_groups(vsites_full):
    """GROMACS [virtual_sitesN] entries -> tuple of VSiteGroup (CPU
    tensors, float64 parameters; `vsite_groups_to` moves them).

    `vsites_full` rows are (global idx tuple, nhosts_kind, funct, params)
    with idx[0] the site and idx[1:] the hosts (io.gmxtop). Raw GROMACS
    units are converted here (nm -> A, deg -> rad, 1/nm -> 1/A)."""
    if not vsites_full:
        return ()
    by_kind: dict = {}
    for idx, nk, funct, prm in vsites_full:
        kind = (int(nk), int(funct))
        prm = list(prm or [])
        if kind == (2, 1):
            p = [prm[0], 0.0, 0.0]
        elif kind == (2, 2):
            p = [prm[0] * 10.0, 0.0, 0.0]
        elif kind == (3, 1):
            p = [prm[0], prm[1], 0.0]
        elif kind == (3, 2):
            p = [prm[0], prm[1] * 10.0, 0.0]
        elif kind == (3, 3):
            p = [np.radians(prm[0]), prm[1] * 10.0, 0.0]
        elif kind == (3, 4):
            p = [prm[0], prm[1], prm[2] / 10.0]
        elif kind == (4, 2):
            p = [prm[0], prm[1], prm[2] * 10.0]
        else:
            raise NotImplementedError(
                f"virtual_sites{nk} funct {funct} is not supported")
        hosts = list(idx[1:]) + [idx[-1]] * (5 - len(idx))
        by_kind.setdefault(kind, []).append((idx[0], hosts[:4], p))
    return tuple(
        VSiteGroup(
            kind=kind,
            sites=torch.as_tensor([r[0] for r in rows], dtype=torch.int64),
            hosts=torch.as_tensor([r[1] for r in rows], dtype=torch.int64),
            params=torch.as_tensor([r[2] for r in rows], dtype=torch.float64),
        )
        for kind, rows in sorted(by_kind.items()))


def vsite_mask(groups, natoms):
    """(natoms,) bool numpy array: True at virtual-site rows."""
    m = np.zeros(natoms, bool)
    for g in groups:
        m[g.sites.cpu().numpy()] = True
    return m
