"""Full Ewald summation for point multipoles (charges, permanent dipoles,
traceless quadrupoles), the port of `torchmd_tpu.multipole_ewald`.

With the multipole operator L_i = q_i + mu_i . grad_{r_i} + (1/6) Q_i :
grad grad_{r_i} (Jackson convention), the energy of a pair under a
radial kernel G is E = L_i L_j G(r_i - r_j). The JAX package evaluates
it by nesting jax.grad / jax.hessian of G; here it is the closed form of
the Smith / McMurchie-Davidson recursion: with d = r_i - r_j and

    B_0 = G(r),   B_{n+1} = -(1/r) dB_n/dr,

every derivative of G is a sum of d and delta products times B_n, and
the pair energy a short polynomial in q, mu . d, d . Q . d, mu . Q . d,
Q : Q and B_0..B_4 (`pair_energy`). The Ewald tiers are three kernels:

  - real space:  erfc(alpha r)/r over non-excluded pairs in the cutoff,
    B_n by the upward recursion B_n = [(2n-1) B_{n-1}
    + (2 alpha^2)^n exp(-alpha^2 r^2) / (alpha sqrt(pi))] / r^2;
  - exclusions:  minus erf(alpha r)/r over the masked pairs. Its upward
    recursion subtracts nearly equal terms at small alpha r (about
    (alpha r)^(2n+1) of the digits lost at rank n), so below
    t = alpha^2 r^2 = 2 the B_n come from their own power series
    B_n = 2 alpha / sqrt(pi) (2 alpha^2)^n sum_m (-t)^m / (m! (2m+2n+1)).
    Below t = 1/4 that series stops where the JAX package's does: it
    differentiates the seven-term series of erf(x)/x (`_g_erf`), which
    leaves B_n the terms m <= 6 - n;
  - self:        -1/2 (L_i L_i G_erf)(0), the series at t = 0.

The reciprocal sum is the separable structure-factor sum of the
multipole-dressed amplitude Lambda_j(k) = q_j + i k . mu_j - (1/6) k^T
Q_j k (`MultipoleEwald`), or smooth PME with derivative B-spline taps
(`MultipolePme`): the ten moment components as separable tap products
scattered onto one mesh with `index_add_`, one `torch.fft.fftn`.
Forces are one `torch.autograd` pass over the energy, frames included.

The pair geometry (the B_n, the phase tables or the spline taps) is
built once per position set (`MultipoleEwald.geometry`) and contracted
with any moments (`energy_geom`): the polarization solver
(`amoeba.AmoebaPolarizationEwald`) reuses it across its CG iterations.
Both are external potentials (`Forces(external=...)`) whose tensors live
on the card unless given `device="cpu"`.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .ewald import bspline_b2, bspline_weights_d2, choose_parameters, pme_mesh_shape
from .multipoles import (BatchedExternal, MultipoleSpec, _to_numpy, lab_dipoles,
                         lab_quadrupoles)
from .potentials import wrap_displacement
from .units import ELEC_FACTOR

# erf(alpha r)/r: the B_n power series below this t = (alpha r)^2, the
# upward recursion above it; SERIES_TERMS makes the series exact to
# rounding there (2^24 / 24! ~ 3e-17). Below JAX_SERIES_T the series is
# the JAX package's seven-term one (`multipole_ewald._g_erf`).
ERF_SERIES_T = 2.0
SERIES_TERMS = 24
JAX_SERIES_T = 0.25
JAX_SERIES_TERMS = 7
_SQRT_PI = math.sqrt(math.pi)


def b_erfc(alpha, r2, nmax):
    """[B_0..B_nmax] of erfc(alpha r)/r at r^2 = r2 > 0."""
    r = torch.sqrt(r2)
    B = [torch.special.erfc(alpha * r) / r]
    ex = torch.exp(-alpha * alpha * r2) / (alpha * _SQRT_PI)
    for n in range(1, nmax + 1):
        B.append(((2 * n - 1) * B[-1] + (2.0 * alpha * alpha) ** n * ex) / r2)
    return B


def _erf_series(t, n, terms):
    """sum_{m < terms} (-t)^m / (m! (2m + 2n + 1)) by Horner."""
    acc = torch.zeros_like(t)
    for m in range(terms - 1, -1, -1):
        acc = acc * -t + 1.0 / (math.factorial(m) * (2 * m + 2 * n + 1))
    return acc


def b_erf(alpha, r2, nmax):
    """[B_0..B_nmax] of erf(alpha r)/r, finite down to r = 0: the
    series below t = ERF_SERIES_T (the JAX package's truncation below
    JAX_SERIES_T), the upward recursion above."""
    t = alpha * alpha * r2
    small, tiny = t < ERF_SERIES_T, t < JAX_SERIES_T
    pre = 2.0 * alpha / _SQRT_PI
    r2_big = torch.where(small, torch.full_like(r2, ERF_SERIES_T / (alpha * alpha)), r2)
    r_big = torch.sqrt(r2_big)
    rec = [torch.special.erf(alpha * r_big) / r_big]
    ex = torch.exp(-alpha * alpha * r2_big) / (alpha * _SQRT_PI)
    out = []
    for n in range(nmax + 1):
        if n:
            rec.append(((2 * n - 1) * rec[-1] - (2.0 * alpha * alpha) ** n * ex) / r2_big)
        ser = torch.where(tiny, _erf_series(t, n, JAX_SERIES_TERMS - n),
                          _erf_series(t, n, SERIES_TERMS))
        out.append(torch.where(small, pre * (2.0 * alpha * alpha) ** n * ser, rec[n]))
    return out


def b_bare(r2, nmax):
    """[B_0..B_nmax] of 1/r: (2n-1)!! / r^(2n+1)."""
    B = [r2 ** -0.5]
    for n in range(1, nmax + 1):
        B.append((2 * n - 1) * B[-1] / r2)
    return B


def _dot(a, b):
    return (a * b).sum(-1)


def _mv(Q, d):
    return torch.einsum("...ab,...b->...a", Q, d)


def pair_energy(B, d, qi, mui, Qi, qj, muj, Qj):
    """E = L_i L_j G(d) per pair, d = r_i - r_j, from G's B_n (no EF).
    Any of q, mu, Q may be None (that moment absent on that side)."""
    E = 0.0
    di = None if mui is None else _dot(mui, d)
    dj = None if muj is None else _dot(muj, d)
    if qi is not None and qj is not None:
        E = E + qi * qj * B[0]
    if mui is not None and qj is not None:
        E = E - qj * di * B[1]
    if muj is not None and qi is not None:
        E = E + qi * dj * B[1]
    if mui is not None and muj is not None:
        E = E + _dot(mui, muj) * B[1] - di * dj * B[2]
    if Qi is None and Qj is None:
        return E
    Qid = None if Qi is None else _mv(Qi, d)
    Qjd = None if Qj is None else _mv(Qj, d)
    tri = None if Qi is None else torch.diagonal(Qi, dim1=-2, dim2=-1).sum(-1)
    trj = None if Qj is None else torch.diagonal(Qj, dim1=-2, dim2=-1).sum(-1)
    dQid = None if Qi is None else _dot(Qid, d)
    dQjd = None if Qj is None else _dot(Qjd, d)
    if Qj is not None and qi is not None:
        E = E + qi * (dQjd * B[2] - trj * B[1]) / 6.0
    if Qi is not None and qj is not None:
        E = E + qj * (dQid * B[2] - tri * B[1]) / 6.0
    if Qj is not None and mui is not None:
        E = E + ((2.0 * _dot(mui, Qjd) + trj * di) * B[2] - di * dQjd * B[3]) / 6.0
    if Qi is not None and muj is not None:
        E = E - ((2.0 * _dot(muj, Qid) + tri * dj) * B[2] - dj * dQid * B[3]) / 6.0
    if Qi is not None and Qj is not None:
        QQ = (Qi * Qj).sum((-2, -1))
        E = E + ((tri * trj + 2.0 * QQ) * B[2]
                 - (tri * dQjd + trj * dQid + 4.0 * _dot(Qid, Qjd)) * B[3]
                 + dQid * dQjd * B[4]) / 36.0
    return E


def self_energy(alpha, q, mu, Q):
    """-1/2 (L L G_erf)(0) per site: the Ewald self term of each site's
    moments (any of q, mu, Q may be None)."""
    B = [2.0 * alpha / _SQRT_PI * (2.0 * alpha * alpha) ** n / (2 * n + 1)
         for n in range(3)]
    e = 0.0
    if q is not None:
        e = e + q * q * B[0]
    if mu is not None:
        e = e + _dot(mu, mu) * B[1]
    if Q is not None:
        tr = torch.diagonal(Q, dim1=-2, dim2=-1).sum(-1)
        if q is not None:
            e = e - q * tr * B[1] / 3.0
        e = e + (tr * tr + 2.0 * (Q * Q).sum((-2, -1))) * B[2] / 36.0
    return -0.5 * e


class Geometry(NamedTuple):
    """Everything of one evaluation that depends on positions only."""

    alpha: float
    V: torch.Tensor
    real: tuple          # (i, j, d, [B_n]) over non-excluded pairs
    excl: Optional[tuple]  # (i, j, d, [B_n of erf]) over excluded pairs
    recip: tuple         # the reciprocal engine's own


def _rows(x, idx):
    return None if x is None else x.index_select(0, idx)


class MultipoleEwald(BatchedExternal):
    """Full Ewald electrostatics (real erfc + exclusions + self + exact
    reciprocal) for charges on every atom and dipoles/quadrupoles on
    `spec.sites`, an external potential replacing both the point-charge
    term and the real-space `Multipoles` on a periodic box.

    box0: the (3,) box that picks alpha and the k-space extent; the
    energy itself follows the box it is given. The real-space tier runs
    over the dense upper triangle of non-excluded pairs, masked by the
    cutoff (the JAX package's layout: hundreds to a few thousand atoms).
    """

    def __init__(self, spec: MultipoleSpec, charges, box0, cutoff, tol=1e-5,
                 device=None):
        if spec.cutoff is not None and float(spec.cutoff) != float(cutoff):
            raise ValueError("spec.cutoff and the Ewald cutoff disagree; build the "
                             "spec with cutoff=None (the Ewald real-space cutoff "
                             "applies here)")
        self.spec = spec
        self.device = spec.sites.device if device is None else torch.device(device)
        self.charges = torch.as_tensor(np.asarray(_to_numpy(charges), np.float64),
                                       device=self.device)
        self.cutoff = float(cutoff)
        self.cfg = choose_parameters(np.asarray(box0), cutoff, tol)
        n = int(self.charges.shape[0])
        mask = np.asarray(_to_numpy(spec.nb_mask), bool)
        iu, ju = np.triu_indices(n, 1)
        inc = mask[iu, ju]

        def ints(v):
            return torch.as_tensor(np.ascontiguousarray(v, np.int64), device=self.device)

        self._real_pairs = (ints(iu[inc]), ints(ju[inc]))
        self._excl_pairs = (ints(iu[~inc]), ints(ju[~inc])) if (~inc).any() else None
        self._nmax = 2 if spec.quad_local is None else 4
        kx, ky, kz = self.cfg.kmax
        self._n = tuple(torch.arange(-k, k + 1, device=self.device) for k in (kx, ky, kz))

    # -- moment assembly -------------------------------------------------
    def _moments(self, pos, box):
        """(q (n,), mu (n, 3), Q (n, 3, 3) or None) in the lab frame."""
        n = self.charges.shape[0]
        q = self.charges.to(pos.dtype)
        s = self.spec.sites
        mu = torch.zeros((n, 3), dtype=pos.dtype, device=pos.device).index_copy(
            0, s, lab_dipoles(self.spec, pos, box))
        Q = None
        if self.spec.quad_local is not None:
            Q = torch.zeros((n, 3, 3), dtype=pos.dtype, device=pos.device).index_copy(
                0, s, lab_quadrupoles(self.spec, pos, box))
        return q, mu, Q

    # -- geometry ----------------------------------------------------------
    def geometry(self, pos, box, alpha=None) -> Geometry:
        box = box.reshape(-1)[:3].to(pos.dtype)
        alpha = float(self.cfg.alpha if alpha is None else alpha)
        i, j = self._real_pairs
        d = wrap_displacement(pos.index_select(0, i) - pos.index_select(0, j), box)
        d2 = _dot(d, d)
        mask = d2 <= self.cutoff ** 2
        Br = b_erfc(alpha, torch.where(mask, d2, torch.ones_like(d2)), self._nmax)
        Br = [torch.where(mask, b, torch.zeros_like(b)) for b in Br]
        excl = None
        if self._excl_pairs is not None:
            ei, ej = self._excl_pairs
            de = wrap_displacement(pos.index_select(0, ei) - pos.index_select(0, ej), box)
            excl = (ei, ej, de, b_erf(alpha, _dot(de, de), self._nmax))
        return Geometry(alpha, box.prod(), (i, j, d, Br), excl,
                        self._recip_geometry(pos, box, alpha))

    def _recip_geometry(self, pos, box, alpha):
        dtype = pos.dtype
        ctype = torch.complex128 if dtype == torch.float64 else torch.complex64
        two_pi = 2.0 * math.pi

        def phase(coords, nvec, L):
            ang = (two_pi / L) * torch.outer(coords, nvec.to(dtype))
            return torch.complex(torch.cos(ang), torch.sin(ang)).to(ctype)

        A = [phase(pos[:, a], self._n[a], box[a]) for a in range(3)]
        ks = [(two_pi / box[a]) * self._n[a].to(dtype) for a in range(3)]
        kvec = torch.stack(torch.meshgrid(*ks, indexing="ij"), -1).reshape(-1, 3)
        k2 = _dot(kvec, kvec)
        k2s = torch.where(k2 > 0, k2, torch.ones_like(k2))
        pref = torch.where(k2 > 0, torch.exp(-k2s / (4.0 * alpha * alpha)) / k2s,
                           torch.zeros_like(k2))
        return A, kvec, pref

    # -- contraction -------------------------------------------------------
    def energy_geom(self, g: Geometry, q, mu, Q):
        """All four Ewald tiers for explicit per-atom moments (any of q,
        mu, Q may be None), raw Gaussian units (no ELEC_FACTOR). Quadratic
        in the moments."""
        i, j, d, Br = g.real
        e = pair_energy(Br, d, _rows(q, i), _rows(mu, i), _rows(Q, i),
                        _rows(q, j), _rows(mu, j), _rows(Q, j)).sum()
        if g.excl is not None:
            ei, ej, de, Be = g.excl
            e = e - pair_energy(Be, de, _rows(q, ei), _rows(mu, ei), _rows(Q, ei),
                                _rows(q, ej), _rows(mu, ej), _rows(Q, ej)).sum()
        e = e + self_energy(g.alpha, q, mu, Q).sum()
        e = e + self._reciprocal(g, q, mu, Q)
        if q is not None:   # net-charge (tinfoil) term
            qtot = q.sum()
            e = e - math.pi / (2.0 * g.V * g.alpha ** 2) * qtot * qtot
        return e

    def _reciprocal(self, g: Geometry, q, mu, Q):
        (Ax, Ay, Az), kvec, pref = g.recip
        ctype = Ax.dtype
        N = Ax.shape[0]

        def sfac(w):
            Wxy = torch.einsum("jx,jy->xyj", Ax * w.to(ctype)[:, None], Ay)
            return (Wxy.reshape(-1, N) @ Az).reshape(-1)

        S = 0.0
        if q is not None:
            S = sfac(q)
        if mu is not None:
            for a in range(3):
                S = S + 1j * kvec[:, a].to(ctype) * sfac(mu[:, a])
        if Q is not None:
            for a in range(3):
                for b in range(3):
                    S = S - (1.0 / 6.0) * (kvec[:, a] * kvec[:, b]).to(ctype) * sfac(Q[:, a, b])
        return (2.0 * math.pi / g.V) * (pref * (S.real ** 2 + S.imag ** 2)).sum()

    # -- protocol ----------------------------------------------------------
    def energy_with_moments(self, pos, box, q, mu, Q, alpha=None):
        """The four tiers for explicit moments at these positions (raw
        units), as the JAX method of that name."""
        box = torch.as_tensor(box, dtype=pos.dtype, device=pos.device)
        return self.energy_geom(self.geometry(pos, box, alpha), q, mu, Q)

    def energy_fn(self, pos, box=None):
        if box is None:
            raise ValueError("MultipoleEwald needs a periodic box")
        box = torch.as_tensor(box, dtype=pos.dtype, device=pos.device).reshape(-1)[:3]
        q, mu, Q = self._moments(pos, box)
        return ELEC_FACTOR * self.energy_with_moments(pos, box, q, mu, Q)


class MultipolePme(MultipoleEwald):
    """MultipoleEwald with the reciprocal sum on a smooth PME mesh: the
    moment density q + mu . grad + (1/6) Q : grad grad applied to the
    B-spline spreading weights (per-axis value, first and second
    derivative taps, `ewald.bspline_weights_d2`), the ten moment
    components as separable tap products summed into one scatter, one
    FFT, the Euler |b(m)|^2 factors and the Gaussian influence function
    (Essmann et al. 1995; Sagui, Pedersen & Darden, JCP 120:73, 2004).
    The quadrupole tier spreads second-derivative taps, so the default
    order is 8."""

    def __init__(self, spec: MultipoleSpec, charges, box0, cutoff, tol=1e-5,
                 order=8, spacing=0.8, device=None):
        super().__init__(spec, charges, box0, cutoff, tol, device=device)
        self.order = int(order)
        self.kmesh = pme_mesh_shape(self.cfg.kmax, box0, spacing)
        b = [torch.as_tensor(bspline_b2(K, self.order), device=self.device)
             for K in self.kmesh]
        self._b2 = b[0][:, None, None] * b[1][None, :, None] * b[2][None, None, :]
        self._m = [torch.as_tensor(np.fft.fftfreq(K, d=1.0 / K), device=self.device)
                   for K in self.kmesh]
        self._K = torch.as_tensor(self.kmesh, device=self.device)

    def _recip_geometry(self, pos, box, alpha):
        dtype = pos.dtype
        n = self.order
        Kx, Ky, Kz = self.kmesh
        Ks = self._K.to(dtype)
        u = pos / box
        u = (u - torch.floor(u)) * Ks
        base = torch.floor(u).detach()
        frac = u - base
        w, dw, d2w = bspline_weights_d2(frac, n)                 # (N, 3, n)
        s1 = (Ks / box)[None, :, None]
        V3 = (w, dw * s1, d2w * s1 * s1)
        idx = torch.remainder(base.long()[..., None]
                              - torch.arange(n, device=pos.device),
                              self._K[None, :, None])
        flat = ((idx[:, 0, :, None, None] * Ky + idx[:, 1, None, :, None]) * Kz
                + idx[:, 2, None, None, :]).reshape(-1)
        two_pi = 2.0 * math.pi
        k = [(two_pi / box[a]) * self._m[a].to(dtype) for a in range(3)]
        k2 = k[0][:, None, None] ** 2 + k[1][None, :, None] ** 2 + k[2][None, None, :] ** 2
        k2s = torch.where(k2 > 0, k2, torch.ones_like(k2))
        pref = torch.where(k2 > 0, torch.exp(-k2s / (4.0 * alpha * alpha)) / k2s,
                           torch.zeros_like(k2)) * self._b2.to(dtype)
        return V3, flat, pref

    def _reciprocal(self, g: Geometry, q, mu, Q):
        V3, flat, pref = g.recip
        terms = []
        if q is not None:
            terms.append((0, 0, 0, q))
        if mu is not None:
            terms += [(1, 0, 0, mu[:, 0]), (0, 1, 0, mu[:, 1]), (0, 0, 1, mu[:, 2])]
        if Q is not None:
            terms += [(2, 0, 0, Q[:, 0, 0] / 6.0), (0, 2, 0, Q[:, 1, 1] / 6.0),
                      (0, 0, 2, Q[:, 2, 2] / 6.0), (1, 1, 0, Q[:, 0, 1] / 3.0),
                      (1, 0, 1, Q[:, 0, 2] / 3.0), (0, 1, 1, Q[:, 1, 2] / 3.0)]
        coef = 0.0
        for a, b, c, cf in terms:
            coef = coef + (cf[:, None, None, None] * V3[a][:, 0, :, None, None]
                           * V3[b][:, 1, None, :, None] * V3[c][:, 2, None, None, :])
        Kx, Ky, Kz = self.kmesh
        mesh = torch.zeros(Kx * Ky * Kz, dtype=coef.dtype, device=coef.device)
        mesh = mesh.index_add(0, flat, coef.reshape(-1)).reshape(Kx, Ky, Kz)
        Sk = torch.fft.fftn(mesh)
        return (2.0 * math.pi / g.V) * (pref * (Sk.real ** 2 + Sk.imag ** 2)).sum()
