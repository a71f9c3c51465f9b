"""Smooth particle-mesh Ewald (PME) electrostatics on torch tensors.

Counterpart of `torchmd_tpu.ewald` (parameter choice, B-spline machinery
and `PmeRecip`). The full Ewald decomposition is

    E = E_real + E_reciprocal + E_self + E_excluded + E_net-charge

where the erfc-damped real-space part rides the pair kernels
(`ForceTermConfig.ewald_alpha`) and `PmeRecip` gives the rest: B-spline
charge spreading onto a (Kx, Ky, Kz) mesh (`ops.pme`), one real-input FFT
(`torch.fft`, cuFFT on the card), the influence function, and forces by
one of two gathers, chosen at construction:

  - "ik": the three spectral-derivative grids i k_a phi(k) (Nyquist modes
    zeroed) and the ik gather kernel; agrees with the exact gradient to
    the spline truncation order (~1e-4 relative at order 4). The default
    for CUDA f32, as on the TPU.
  - "exact": the analytic gradient of the spread (spline-derivative taps
    against the convolved potential grid), exact to round-off; the
    default otherwise (f64, CPU).

Self, net-charge and excluded-pair corrections are analytic in the
positions. `energy_forces_virial` adds the per-axis scaling virial
-dE/ds_a of E(s pos, s box) that the MTK barostat needs, analytically:
the JAX package takes it by autodiff of `ewald.energy`, which the spread
kernel here does not support. The exact separable Ewald sum
(`EwaldRecip`) comes with a later slice of the port.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .ops import pme as _pme
from .ops.pme import bspline_dweights, bspline_weights  # noqa: F401 (API)
from .units import ELEC_FACTOR

# Spline order switch: order 6 (~1e-5 relative force error) below this
# many atoms, order 4 (~1e-4) at and above it. Provisional: the JAX
# package's value, tuned on a TPU; not yet measured on the H100.
ORDER4_MIN_ATOMS = 16384
GATHERS = ("ik", "exact")


class EwaldConfig(NamedTuple):
    alpha: float
    kmax: tuple          # PmeRecip: the mesh shape (Kx, Ky, Kz)
    tol: float


def bspline_b2(K, n):
    """|b(m)|^2 Euler-spline factors for mesh size K (numpy; Essmann eq.
    4.4). Degenerate modes (Nyquist zeros of even-order splines) get
    factor 0, i.e. are dropped from the sum."""
    pts = bspline_weights(torch.zeros(1, dtype=torch.float64), n)[0].numpy()[1:n]
    m = np.arange(K)
    denom = sum(pts[k] * np.exp(2j * np.pi * m * k / K) for k in range(n - 1))
    mag2 = np.abs(denom) ** 2
    return np.where(mag2 < 1e-12, 0.0, 1.0 / np.where(mag2 < 1e-12, 1.0, mag2))


def pme_fast_len(n):
    """Next 2/3/5-smooth length >= n (FFT-friendly sizes)."""
    n = max(int(n), 16)
    while True:
        m = n
        for f in (2, 3, 5):
            while m % f == 0:
                m //= f
        if m == 1:
            return n
        n += 1


def pme_mesh_shape(kmax, box, spacing=1.0):
    """Mesh sizes satisfying both the k-space tolerance (2*kmax+1) and
    the spline interpolation error (~`spacing` Angstrom spacing)."""
    box = np.asarray(box, np.float64).reshape(-1)[:3]
    return tuple(pme_fast_len(max(2 * k + 1, int(np.ceil(L / spacing))))
                 for k, L in zip(kmax, box))


def choose_parameters(box, cutoff, tol=1e-5) -> EwaldConfig:
    """alpha from the real-space tolerance at the cutoff, K from the
    reciprocal-space tolerance (standard Ewald heuristics)."""
    box = np.asarray(box, dtype=np.float64).reshape(-1)[:3]
    if np.any(box <= 0):
        raise ValueError("Ewald requires a periodic box")
    alpha = np.sqrt(-np.log(2.0 * tol)) / cutoff
    kcut = 2.0 * alpha * np.sqrt(-np.log(tol))
    kmax = tuple(int(np.ceil(kcut * L / (2 * np.pi))) for L in box)
    return EwaldConfig(float(alpha), kmax, float(tol))


def erf_over_r_sum(alpha, dv, qq):
    """(-sum qq erf(alpha r)/r over the pairs, its gradient wrt dv).

    Finite at r = 0: below t = (alpha r)^2 = 1/4 the series
    erf(x)/x = 2/sqrt(pi) (1 - t/3 + t^2/10 - ...) takes over, analytic
    in r^2."""
    r2 = (dv * dv).sum(-1)
    t = alpha * alpha * r2
    small = t < 0.25
    coef = (1.0, -1.0 / 3.0, 1.0 / 10.0, -1.0 / 42.0, 1.0 / 216.0,
            -1.0 / 1320.0, 1.0 / 9360.0)
    ser = torch.zeros_like(t)
    dser = torch.zeros_like(t)   # d ser / dt
    for k in range(len(coef) - 1, -1, -1):
        ser = ser * t + coef[k]
        if k:
            dser = dser * t + k * coef[k]
    c = alpha * 2.0 / math.sqrt(math.pi)
    r_safe = torch.sqrt(torch.where(small, torch.ones_like(r2), r2))
    erf_t = torch.special.erf(alpha * r_safe)
    g = torch.where(small, c * ser, erf_t / r_safe)
    # dg/d(r^2)
    dg_exact = (c * torch.exp(-(alpha * r_safe) ** 2) / r_safe
                - erf_t / (r_safe * r_safe)) / (2.0 * r_safe)
    dg = torch.where(small, c * alpha * alpha * dser, dg_exact)
    return -(qq * g).sum(), -(2.0 * qq * dg)[:, None] * dv


class PmeRecip:
    """Reciprocal + self + net-charge + excluded-pair energy and forces of
    one topology (Essmann et al. 1995).

    charges: (N,) tensor (its device and dtype are used unless given) or
    array; box: the concrete box diagonal the mesh is sized for;
    excl_pairs: (P, 2) excluded atom pairs, whose full-lattice reciprocal
    interaction is cancelled with -qq erf(alpha r)/r. `gather` is "ik" or
    "exact" (default: "ik" for CUDA f32, else "exact"). With `plain=True`
    the spread and ik gather run their plain PyTorch versions on any
    device; otherwise they follow the device (kernels on CUDA)."""

    def __init__(self, charges, box, cutoff, excl_pairs=None, tol=1e-5,
                 dtype=None, device=None, spacing=1.0, order=None, gather=None,
                 plain=False):
        if isinstance(charges, torch.Tensor):
            device = charges.device if device is None else device
            dtype = charges.dtype if dtype is None else dtype
        if device is None:
            from .systems import resolve_device

            device = resolve_device(None)
        self.device = torch.device(device)
        self.dtype = torch.float32 if dtype is None else dtype
        self.charges = torch.as_tensor(
            charges if isinstance(charges, torch.Tensor) else np.asarray(charges),
            dtype=self.dtype, device=self.device)
        natoms = int(self.charges.shape[0])
        if order is None:
            order = 6 if natoms < ORDER4_MIN_ATOMS else 4
        self.ORDER = int(order)
        base = choose_parameters(box, cutoff, tol)
        kmesh = pme_mesh_shape(base.kmax, box, spacing)
        if min(kmesh) < self.ORDER:
            raise ValueError(f"PME mesh {kmesh} is smaller than the spline order")
        self.cfg = EwaldConfig(base.alpha, kmesh, base.tol)
        self.excl = None
        if excl_pairs is not None and len(excl_pairs):
            # deduplicate: exclusion sources overlap and the erf correction
            # must be applied exactly once per pair
            pairs = np.unique(np.sort(np.asarray(excl_pairs, np.int64), axis=1), axis=0)
            self.excl = torch.as_tensor(pairs, device=self.device)
        if gather is None:
            gather = ("ik" if self.device.type == "cuda"
                      and self.dtype == torch.float32 else "exact")
        if gather not in GATHERS:
            raise ValueError(f"gather={gather!r} (want one of {GATHERS})")
        self.gather = gather
        self._spread_fn = _pme.spread_reference if plain else _pme.pme_spread
        self._gather_fn = _pme.gather_ik_reference if plain else _pme.pme_gather_ik
        # Euler-spline |b(m)|^2 correction factors, static per mesh axis
        self._b2 = tuple(torch.as_tensor(bspline_b2(K, self.ORDER),
                                         dtype=self.dtype, device=self.device)
                         for K in kmesh)

    # ------------------------------------------------------------------
    def _box(self, box, like):
        return torch.as_tensor(box, dtype=like.dtype, device=like.device).reshape(3)

    def _kvec(self, K, L, nyquist_zero=False):
        m = torch.fft.fftfreq(K, d=1.0 / K, dtype=L.dtype, device=L.device)
        if nyquist_zero and K % 2 == 0:
            # the Nyquist mode has no well-defined odd derivative on a
            # real grid: zero it
            m[K // 2] = 0.0
        return (2.0 * math.pi / L) * m

    def _kzvec(self, K, L, nyquist_zero=False):
        m = torch.arange(K // 2 + 1, dtype=L.dtype, device=L.device)
        if nyquist_zero and K % 2 == 0:
            m[-1] = 0.0
        return (2.0 * math.pi / L) * m

    def _bhalf(self, box):
        """Half-spectrum (rfftn layout) influence function B = pref*b2
        plus the hermitian doubling weights for the energy sum."""
        Kx, Ky, Kz = self.cfg.kmax
        alpha = self.cfg.alpha
        kx, ky, kz = self._kvec(Kx, box[0]), self._kvec(Ky, box[1]), self._kzvec(Kz, box[2])
        k2 = kx[:, None, None] ** 2 + ky[None, :, None] ** 2 + kz[None, None, :] ** 2
        k2_safe = torch.where(k2 > 0, k2, torch.ones_like(k2))
        pref = torch.where(k2 > 0, torch.exp(-k2_safe / (4.0 * alpha**2)) / k2_safe,
                           torch.zeros_like(k2))
        bx, by, bz = self._b2
        b2 = bx[:, None, None] * by[None, :, None] * bz[:Kz // 2 + 1][None, None, :]
        return pref * b2.to(pref.dtype), self._zweights(box)

    def _zweights(self, box):
        """Hermitian weights of the half spectrum's kz columns: kz = 0 (and
        the Nyquist plane when Kz is even) appear once in the full
        spectrum; every other column stands for itself and its conjugate."""
        Kz = self.cfg.kmax[2]
        w = torch.full((Kz // 2 + 1,), 2.0, dtype=box.dtype, device=box.device)
        w[0] = 1.0
        if Kz % 2 == 0:
            w[-1] = 1.0
        return w

    def _corrections(self, pos, box, q):
        """Self + net-charge + exclusion terms: (energy, forces, per-axis
        virial). The self term does not depend on the box; the net-charge
        term goes as 1/V, so its virial is its energy on every axis; the
        exclusion pairs' is -sum grad_a dv_a (grad = dE/d dv)."""
        alpha = self.cfg.alpha
        V = box[0] * box[1] * box[2]
        e = -ELEC_FACTOR * alpha / math.sqrt(math.pi) * (q * q).sum()
        qtot = q.sum()
        e_net = -ELEC_FACTOR * math.pi / (2.0 * V * alpha**2) * qtot * qtot
        e = e + e_net
        forces = torch.zeros_like(pos)
        vir = e_net * torch.ones_like(box)
        if self.excl is not None:
            i, j = self.excl[:, 0], self.excl[:, 1]
            dv = pos[i] - pos[j]
            dv = dv - box * torch.round(dv / box)
            e_ex, grad = erf_over_r_sum(alpha, dv, ELEC_FACTOR * q[i] * q[j])
            e = e + e_ex
            forces.index_add_(0, i, -grad)
            forces.index_add_(0, j, grad)
            vir = vir - (grad * dv).sum(0)
        return e, forces, vir

    def _mesh_energy(self, pos, box, q, order_idx=None):
        """(reciprocal energy, rfftn of the mesh, B, c = k_e 2 pi / V);
        `order_idx`: the spread's order of the atoms in space (`ops.pme`)."""
        mesh = self._spread_fn(pos, q, box, self.cfg.kmax, self.ORDER, order_idx)
        Sk = torch.fft.rfftn(mesh)
        B, w = self._bhalf(box)
        c = ELEC_FACTOR * (2.0 * math.pi) / (box[0] * box[1] * box[2])
        s2 = (Sk.real**2 + Sk.imag**2).to(pos.dtype)
        return c * ((B * s2) @ w).sum(), Sk, B, c

    def energy(self, pos, box):
        """Reciprocal + self + net-charge + exclusion terms (kcal/mol)."""
        box = self._box(box, pos)
        q = self.charges.to(pos.dtype)
        e_recip = self._mesh_energy(pos, box, q)[0]
        return e_recip + self._corrections(pos, box, q)[0]

    def _ik_grids(self, BS, box, scale, dtype):
        """The three spectral-derivative grids of the convolved potential:
        scale * irfftn(i k_a B S(k)), Nyquist modes zeroed."""
        Kx, Ky, Kz = kmesh = self.cfg.kmax
        ks = (self._kvec(Kx, box[0], True)[:, None, None],
              self._kvec(Ky, box[1], True)[None, :, None],
              self._kzvec(Kz, box[2], True)[None, None, :])
        return [(scale * torch.fft.irfftn(1j * k * BS, s=kmesh)).to(dtype).contiguous()
                for k in ks]

    def ik_grids(self, pos, box):
        """The ik gather's three input grids for these positions."""
        box = self._box(box, pos)
        _, Sk, B, c = self._mesh_energy(pos, box, self.charges.to(pos.dtype))
        return self._ik_grids(B.to(Sk.dtype) * Sk, box,
                              2.0 * c * int(np.prod(self.cfg.kmax)), pos.dtype)

    def energy_forces(self, pos, box, gather=None, order_idx=None):
        """(energy, forces (N, 3)) with `gather` ("ik" or "exact"; default
        the constructor's). `order_idx`, atom ids in an order close in
        space with every atom once (a cell list's slots, the columns' i
        slots), lets the spread kernel sum nearby atoms in shared memory;
        the result does not depend on it."""
        return self._evaluate(pos, box, gather, False, order_idx)

    def energy_forces_virial(self, pos, box, gather=None, order_idx=None):
        """(energy, forces (N, 3), per-axis virial (3,)): the virial is
        -dE/ds_a of E(s pos, s box). Scaling leaves the fractional
        coordinates, so the mesh and |S(k)|^2 and the b^2 factors, as they
        are; each mode's energy E_k = c w B(k) |S(k)|^2 moves through
        c ~ 1/V and exp(-k^2 / 4 alpha^2) / k^2 with k_a ~ 1/s_a:
        -dE/ds_a = sum_k E_k [1 - 2 k_a^2 (1/k^2 + 1/(4 alpha^2))], plus
        the corrections' terms (`_corrections`). `order_idx` as for
        `energy_forces`."""
        return self._evaluate(pos, box, gather, True, order_idx)

    def _evaluate(self, pos, box, gather, with_virial, order_idx=None):
        gather = self.gather if gather is None else gather
        if gather not in GATHERS:
            raise ValueError(f"gather={gather!r} (want one of {GATHERS})")
        box = self._box(box, pos)
        q = self.charges.to(pos.dtype)
        e_recip, Sk, B, c = self._mesh_energy(pos, box, q, order_idx)
        scale = 2.0 * c * int(np.prod(self.cfg.kmax))
        BS = B.to(Sk.dtype) * Sk
        if gather == "ik":
            grids = self._ik_grids(BS, box, scale, pos.dtype)
            frc = self._gather_fn(pos, q, box, grids, self.ORDER)
        else:
            phi = (scale * torch.fft.irfftn(BS, s=self.cfg.kmax)).to(pos.dtype)
            frc = _gather_exact(pos, q, box, phi, self.ORDER)
        e_corr, f_corr, v_corr = self._corrections(pos, box, q)
        if not with_virial:
            return e_recip + e_corr, frc + f_corr
        return e_recip + e_corr, frc + f_corr, self._recip_virial(Sk, B, c, box) + v_corr

    def _recip_virial(self, Sk, B, c, box):
        """sum_k E_k [1 - 2 k_a^2 (1/k^2 + 1/(4 alpha^2))] per axis a."""
        Kx, Ky, Kz = self.cfg.kmax
        ka2 = (self._kvec(Kx, box[0])[:, None, None] ** 2,
               self._kvec(Ky, box[1])[None, :, None] ** 2,
               self._kzvec(Kz, box[2])[None, None, :] ** 2)
        k2 = ka2[0] + ka2[1] + ka2[2]
        inv = torch.where(k2 > 0, 1.0 / torch.where(k2 > 0, k2, torch.ones_like(k2)),
                          torch.zeros_like(k2)) + 1.0 / (4.0 * self.cfg.alpha**2)
        Ek = c * B * (Sk.real**2 + Sk.imag**2).to(box.dtype) * self._zweights(box)
        return torch.stack([(Ek * (1.0 - 2.0 * a2 * inv)).sum() for a2 in ka2])


def _gather_exact(pos, q, box, phi, order):
    """Forces -dE/dpos from the convolved potential grid phi = dE/dmesh
    and the spline-derivative taps (the exact gradient of the spread)."""
    w, flat, dw = _pme.spline_taps(pos, box, tuple(phi.shape), order, deriv=True)
    vals = phi.reshape(-1)[flat]                           # (N, p, p, p)
    qn = q[:, None, None, None]
    wx, wy, wz = w[:, 0, :, None, None], w[:, 1, None, :, None], w[:, 2, None, None, :]
    dx, dy, dz = dw[:, 0, :, None, None], dw[:, 1, None, :, None], dw[:, 2, None, None, :]
    return -torch.stack([(qn * dx * wy * wz * vals).sum((1, 2, 3)),
                         (qn * wx * dy * wz * vals).sum((1, 2, 3)),
                         (qn * wx * wy * dz * vals).sum((1, 2, 3))], dim=1)
