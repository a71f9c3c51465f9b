"""Collective variables, harmonic biases (umbrella sampling, restrained
MD) and a 1-D WHAM estimator: the port of `torchmd_tpu.cv`.

A CV is a differentiable torch function of one conformation's positions
(and box); a bias is an external potential (`energy_fn(pos, box) ->
scalar`), so `Forces(..., external=bias)` (or `external.
combine_externals` with other sources) folds the restraint into every
force evaluation with forces by autograd. Umbrella windows are
independent `Forces` and `Integrator` pairs; `wham` (host numpy) combines
the sampled CV series into a potential of mean force.

Energy convention: E_bias = 0.5 k (cv - center)^2, kcal/mol with the CV
in its natural unit (Angstrom or radian).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .potentials import _dihedral_phi, wrap_displacement
from .units import BOLTZMANN

__all__ = [
    "distance_cv", "angle_cv", "dihedral_cv", "com_distance_cv",
    "HarmonicBias", "wham",
]


def _box(box, pos):
    """A box diagonal as a tensor on pos's device and dtype, or None."""
    if box is None:
        return None
    return torch.as_tensor(box, dtype=pos.dtype, device=pos.device).reshape(-1)[:3]


def distance_cv(i, j):
    """CV: distance between atoms i and j (minimum image when boxed)."""
    i, j = int(i), int(j)

    def cv(pos, box=None):
        dv = wrap_displacement(pos[i] - pos[j], _box(box, pos))
        return torch.sqrt(torch.clamp((dv * dv).sum(), min=1e-32))

    return cv


def angle_cv(i, j, k):
    """CV: angle i-j-k in radians."""
    i, j, k = int(i), int(j), int(k)

    def cv(pos, box=None):
        b = _box(box, pos)
        r1 = wrap_displacement(pos[i] - pos[j], b)
        r2 = wrap_displacement(pos[k] - pos[j], b)
        c = (r1 * r2).sum() / torch.sqrt(
            torch.clamp((r1 * r1).sum() * (r2 * r2).sum(), min=1e-32))
        c = torch.clamp(c, -1.0, 1.0)
        s = torch.sqrt(torch.clamp(1.0 - c * c, min=1e-24))
        return torch.atan2(s, c)

    return cv


def dihedral_cv(i, j, k, l):  # noqa: E741
    """CV: dihedral i-j-k-l in radians (the force field's torsion sign
    convention)."""
    idx = torch.tensor([[int(i), int(j), int(k), int(l)]])

    def cv(pos, box=None):
        return _dihedral_phi(pos, idx.to(pos.device), _box(box, pos))[0]

    return cv


def com_distance_cv(group_a, group_b, masses=None):
    """CV: distance between the (mass-weighted) centres of two atom
    groups. With PBC the centres use raw coordinates (groups are assumed
    whole); their separation is minimum-imaged."""
    ia = np.asarray(group_a, dtype=np.int64).reshape(-1)
    ib = np.asarray(group_b, dtype=np.int64).reshape(-1)
    if masses is not None:
        m = np.asarray(masses, dtype=np.float64).reshape(-1)
        wa, wb = m[ia] / m[ia].sum(), m[ib] / m[ib].sum()
    else:
        wa, wb = np.full(len(ia), 1.0 / len(ia)), np.full(len(ib), 1.0 / len(ib))
    cache = {}

    def rows(pos):
        key = (pos.device, pos.dtype)
        if key not in cache:
            cache[key] = tuple(torch.as_tensor(a, device=pos.device, dtype=dt)
                               for a, dt in ((ia, torch.long), (ib, torch.long),
                                             (wa, pos.dtype), (wb, pos.dtype)))
        return cache[key]

    def cv(pos, box=None):
        ga, gb, wa_t, wb_t = rows(pos)
        ca = (pos[ga] * wa_t[:, None]).sum(0)
        cb = (pos[gb] * wb_t[:, None]).sum(0)
        dv = wrap_displacement(ca - cb, _box(box, pos))
        return torch.sqrt(torch.clamp((dv * dv).sum(), min=1e-32))

    return cv


class HarmonicBias:
    """Harmonic restraint on a CV: E = 0.5 k (cv - center)^2 (with the
    periodic wrap of the difference for angular CVs). An external
    potential: one bias per umbrella window."""

    def __init__(self, cv_fn, k, center, periodic=False):
        self.cv_fn = cv_fn
        self.k = float(k)
        self.center = float(center)
        self.periodic = bool(periodic)

    def energy_fn(self, pos, box=None):
        x = self.cv_fn(pos, box) - self.center
        if self.periodic:
            x = x - 2.0 * math.pi * torch.round(x / (2.0 * math.pi))
        return 0.5 * self.k * x * x

    def cv_value(self, pos, box=None):
        return self.cv_fn(pos, box)

    def calculate(self, pos, box=None):
        """The batched host protocol: (energy (R,), forces (R, N, 3)) as
        tensors; the box reaches the CV as on the device path."""
        from .external import TorchExternal

        return TorchExternal(self.energy_fn).calculate(pos, box)


def wham(cv_series, centers, k, kT=None, T=300.0, nbins=60, bias_energies=None,
         periodic=False, tol=1e-8, maxiter=10000):
    """1-D weighted-histogram analysis over umbrella windows (host numpy).

    cv_series: one 1-D array of sampled CV values per window; centers / k:
    the windows' harmonic parameters (k scalar or per window). Returns
    (bin centres, PMF in kcal/mol shifted to a minimum of 0).
    Self-consistent WHAM (Kumar et al. 1992):
        p_b = sum_i n_ib / sum_i N_i exp((f_i - w_ib)/kT)
        exp(-f_i/kT) = sum_b p_b exp(-w_ib/kT)
    """
    if kT is None:
        kT = BOLTZMANN * T
    series = [np.asarray(s, dtype=np.float64).reshape(-1) for s in cv_series]
    centers = np.asarray(centers, dtype=np.float64).reshape(-1)
    kk = np.broadcast_to(np.asarray(k, dtype=np.float64), centers.shape)
    if len(series) != len(centers):
        raise ValueError("one CV series per window required")

    lo = min(s.min() for s in series)
    hi = max(s.max() for s in series)
    edges = np.linspace(lo, hi + 1e-12, nbins + 1)
    xb = 0.5 * (edges[:-1] + edges[1:])

    nwin = len(series)
    n_ib = np.stack([np.histogram(s, bins=edges)[0] for s in series])
    N_i = n_ib.sum(axis=1)

    dx = xb[None, :] - centers[:, None]
    if periodic:
        dx = dx - 2.0 * np.pi * np.round(dx / (2.0 * np.pi))
    w_ib = 0.5 * kk[:, None] * dx * dx
    if bias_energies is not None:
        w_ib = np.asarray(bias_energies, dtype=np.float64)

    f = np.zeros(nwin)
    num = n_ib.sum(axis=0)
    for _ in range(maxiter):
        denom = np.sum(N_i[:, None] * np.exp((f[:, None] - w_ib) / kT), axis=0)
        with np.errstate(divide="ignore", invalid="ignore"):
            p = np.where(denom > 0, num / denom, 0.0)
        zi = np.sum(p[None, :] * np.exp(-w_ib / kT), axis=1)
        f_new = -kT * np.log(np.maximum(zi, 1e-300))
        f_new -= f_new[0]
        if np.max(np.abs(f_new - f)) < tol:
            f = f_new
            break
        f = f_new
    denom = np.sum(N_i[:, None] * np.exp((f[:, None] - w_ib) / kT), axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        p = np.where(denom > 0, num / denom, 0.0)
    with np.errstate(divide="ignore"):
        pmf = -kT * np.log(np.maximum(p, 1e-300))
    good = p > 0
    pmf = pmf - pmf[good].min()
    pmf[~good] = np.nan
    return xb, pmf
