"""Generalized-Born implicit solvent (OBC-II) with the ACE surface term,
the port of `torchmd_tpu.gb`.

The standard GB/OBC model (Onufriev, Bashford & Case 2004; igb=5 in
Amber, GBSAOBCForce in OpenMM) as torch ops over a dense masked (N, N)
pair matrix, as the JAX package writes it (it has no Pallas kernel):

  1. HCT pairwise descreening integrals,
  2. the OBC tanh rescaling of the Born radii
     1/B_i = 1/rho_i - tanh(a psi - b psi^2 + g psi^3) / R_i,
     (a, b, g) = (1.0, 0.8, 4.85),
  3. E_GB = -1/2 ke (1/eps_in - 1/eps_out) sum_ij q_i q_j / f_GB,
     f_GB = sqrt(r^2 + B_i B_j exp(-r^2 / (4 B_i B_j))) with the i = j
     self terms,
  4. optionally the ACE nonpolar term sigma 4 pi (R + r_probe)^2 (R/B)^6.

`energy_fn` is the energy (forces by autograd); `energy_forces_fn` the
analytic three passes (Born radii and the chain factor dB/dI; the pair
energy, its explicit gradient and dE/dB; the chain through the HCT
integrals, whose derivative in r is written out here where the JAX
package takes a forward-mode jvp), with only O(N) state between passes.
`GBSA` is an external potential (`Forces(external=...)`,
`external.combine_externals`). Its tensors live on the card unless it is
given `device="cpu"`. Radii and screening factors come from a prmtop's
RADII and SCREEN sections (`make_gbsa`) or from element defaults
(`default_radii`).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .potentials import wrap_displacement
from .systems import resolve_device
from .units import ELEC_FACTOR

__all__ = ["GBSA", "default_radii", "make_gbsa"]

OFFSET = 0.09          # dielectric offset [A]
ALPHA, BETA, GAMMA = 1.0, 0.8, 4.85   # OBC-II
# the bare ACE surface tension (the energy multiplies by 4 pi itself)
ACE_SIGMA = 0.0054     # kcal/mol/A^2
PROBE = 1.4            # water probe radius [A]

# mbondi2 intrinsic radii [A] and HCT screening factors by element
RADIUS_BY_ELEMENT = {
    "H": 1.2, "C": 1.7, "N": 1.55, "O": 1.5, "F": 1.5,
    "Si": 2.1, "P": 1.85, "S": 1.8, "Cl": 1.7, "Br": 1.85, "I": 1.98,
}
SCREEN_BY_ELEMENT = {
    "H": 0.85, "C": 0.72, "N": 0.79, "O": 0.85, "F": 0.88,
    "P": 0.86, "S": 0.96,
}


def default_radii(elements):
    """(radii [A], screen) per atom from element symbols (mbondi2-style)."""
    r = np.array([RADIUS_BY_ELEMENT.get(str(e), 1.5) for e in elements])
    s = np.array([SCREEN_BY_ELEMENT.get(str(e), 0.8) for e in elements])
    return r, s


def _hct(r, rho_i, S_j):
    """The HCT descreening integral of sphere j over the shell of i at
    distance r, with its engulfed correction; (N, N)."""
    L = torch.maximum(torch.abs(r - S_j), rho_i)
    U = r + S_j
    inv_L, inv_U = 1.0 / L, 1.0 / U
    term = (inv_L - inv_U + 0.25 * r * (inv_U ** 2 - inv_L ** 2)
            + (0.5 / r) * torch.log(L * inv_U)
            + (0.25 * S_j * S_j / r) * (inv_L ** 2 - inv_U ** 2))
    engulfed = rho_i < S_j - r
    return term + torch.where(engulfed, 2.0 * (1.0 / rho_i - inv_L), torch.zeros_like(r))


def _hct_dr(r, rho_i, S_j):
    """d/dr of `_hct` (the engulfed test is a step: no derivative)."""
    x = r - S_j
    far = torch.abs(x) > rho_i
    L = torch.where(far, torch.abs(x), rho_i.expand_as(r))
    Lp = torch.where(far, torch.sign(x), torch.zeros_like(r))
    U = r + S_j
    inv_L, inv_U = 1.0 / L, 1.0 / U
    inv_L2, inv_U2 = inv_L * inv_L, inv_U * inv_U
    inv_r = 1.0 / r
    d = (-Lp * inv_L2 + inv_U2
         + 0.25 * (inv_U2 - inv_L2) + 0.5 * r * (inv_L2 * inv_L * Lp - inv_U2 * inv_U)
         - 0.5 * inv_r * inv_r * torch.log(L * inv_U) + 0.5 * inv_r * (Lp * inv_L - inv_U)
         - 0.25 * S_j * S_j * inv_r * inv_r * (inv_L2 - inv_U2)
         + 0.5 * S_j * S_j * inv_r * (inv_U2 * inv_U - inv_L2 * inv_L * Lp))
    engulfed = rho_i < S_j - r
    return d + torch.where(engulfed, 2.0 * Lp * inv_L2, torch.zeros_like(r))


class GBSA:
    """OBC-II generalized Born + ACE surface-area energy term.

    charges (n,) [e]; radii (n,) intrinsic Born radii [A]; screen (n,) HCT
    factors. `sa=True` adds the nonpolar ACE term; `cutoff` drops pairs
    beyond it. An external potential: `energy_fn(pos, box)`,
    `energy_forces_fn(pos, box)` and the batched `calculate`."""

    def __init__(self, charges, radii, screen, solvent_dielectric=78.5,
                 solute_dielectric=1.0, sa=True, cutoff=None, device=None):
        self.device = resolve_device(device)

        def f64(x):
            return torch.as_tensor(np.array(x, dtype=np.float64).reshape(-1),
                                   device=self.device)

        self.charges, self.radii, self.screen = f64(charges), f64(radii), f64(screen)
        self.eps_out = float(solvent_dielectric)
        self.eps_in = float(solute_dielectric)
        self.sa = bool(sa)
        self.cutoff = cutoff
        self.natoms = int(self.charges.shape[0])
        self._rows = {}

    def _per_atom(self, dtype):
        """(q, R, rho, S) rows at `dtype`, made once per dtype."""
        if dtype not in self._rows:
            rho = self.radii - OFFSET
            self._rows[dtype] = tuple(t.to(dtype) for t in (
                self.charges, self.radii, rho, self.screen * rho))
        return self._rows[dtype]

    def _pairs(self, pos, box):
        """(displacements (N, N, 3), d^2 (N, N), the diagonal mask)."""
        dv = wrap_displacement(pos[:, None, :] - pos[None, :, :], box)
        eye = torch.eye(pos.shape[0], dtype=torch.bool, device=pos.device)
        return dv, (dv * dv).sum(-1), eye

    def _born_terms(self, d2, eye, rho, S):
        """(r with 1 on the diagonal, the HCT sums I (N,), active pairs)."""
        r = torch.sqrt(torch.where(eye, torch.ones_like(d2), d2))
        rho_i, S_j = rho[:, None], S[None, :]
        active = ~eye & (rho_i < r + S_j)
        if self.cutoff is not None:
            active = active & (r <= self.cutoff)
        I = torch.where(active, _hct(r, rho_i, S_j), torch.zeros_like(r)).sum(1)
        return r, I, active

    def born_radii(self, pos, box=None):
        """(n,) OBC Born radii of one conformation."""
        _, R, rho, S = self._per_atom(pos.dtype)
        _, d2, eye = self._pairs(pos, box)
        _, I, _ = self._born_terms(d2, eye, rho, S)
        psi = 0.5 * I * rho
        t = torch.tanh(ALPHA * psi - BETA * psi ** 2 + GAMMA * psi ** 3)
        return 1.0 / (1.0 / rho - t / R)

    def _pref(self):
        return -0.5 * ELEC_FACTOR * (1.0 / self.eps_in - 1.0 / self.eps_out)

    def _sa_energy(self, B, R):
        Rp = R + PROBE
        return (ACE_SIGMA * 4.0 * math.pi * Rp * Rp * (R / B) ** 6).sum()

    def energy_fn(self, pos, box=None):
        """The GB (+ ACE) energy of one conformation, differentiable."""
        q, R, _, _ = self._per_atom(pos.dtype)
        B = self.born_radii(pos, box)
        _, d2, eye = self._pairs(pos, box)
        BB = B[:, None] * B[None, :]
        f_gb = torch.sqrt(d2 + BB * torch.exp(-d2 / (4.0 * BB)))
        e_pair = self._pref() * q[:, None] * q[None, :] / f_gb
        if self.cutoff is not None:
            e_pair = torch.where(eye | (d2 <= self.cutoff ** 2), e_pair,
                                 torch.zeros_like(e_pair))
        e = e_pair.sum()
        if self.sa:
            e = e + self._sa_energy(B, R)
        return e

    def energy_forces_fn(self, pos, box=None):
        """(energy, forces) by the analytic three passes (OpenMM's
        ReferenceObc::computeBornEnergyForces and its OBC chain), equal to
        -autograd of `energy_fn`."""
        q, R, rho, S = self._per_atom(pos.dtype)
        dv, d2, eye = self._pairs(pos, box)
        # pass 1: Born radii and the chain factor c = dB/dI
        r, I, active = self._born_terms(d2, eye, rho, S)
        psi = 0.5 * I * rho
        t = torch.tanh(ALPHA * psi - BETA * psi ** 2 + GAMMA * psi ** 3)
        B = 1.0 / (1.0 / rho - t / R)
        c = (B * B / R) * (1.0 - t * t) * (ALPHA - 2.0 * BETA * psi
                                           + 3.0 * GAMMA * psi ** 2) * 0.5 * rho
        # pass 2: the pair energy, its r-gradient and dE/dB
        BB = B[:, None] * B[None, :]
        e_exp = torch.exp(-d2 / (4.0 * BB))
        f2 = d2 + BB * e_exp
        f_gb = torch.sqrt(f2)
        pq = self._pref() * q[:, None] * q[None, :]
        e_pair = pq / f_gb
        inv_2f3 = 1.0 / (2.0 * f2 * f_gb)
        # dE_ij/dd2 = -pref qq (1 - e/4) / (2 f^3), symmetric
        dEdd2 = -pq * (1.0 - 0.25 * e_exp) * inv_2f3
        # dE_ij/dB_i = -pref qq e (B_j + d2 / (4 B_i)) / (2 f^3)
        G1 = -pq * e_exp * (B[None, :] + d2 / (4.0 * B[:, None])) * inv_2f3
        if self.cutoff is not None:
            keep = eye | (d2 <= self.cutoff ** 2)
            zero = torch.zeros_like(d2)
            e_pair = torch.where(keep, e_pair, zero)
            dEdd2 = torch.where(keep, dEdd2, zero)
            G1 = torch.where(keep, G1, zero)
        e = e_pair.sum()
        # the second-slot derivative of pair (j, k) equals the first-slot
        # one of (k, j): both sums are the same row sum (the diagonal twice)
        dEdB = 2.0 * G1.sum(1)
        grad = torch.einsum("ij,ijk->ik", 4.0 * dEdd2, dv)
        if self.sa:
            e = e + self._sa_energy(B, R)
            Rp = R + PROBE
            dEdB = dEdB - 6.0 * ACE_SIGMA * 4.0 * math.pi * Rp * Rp * (R / B) ** 6 / B
        # pass 3: dE/dB through the descreening integrals
        dterm = torch.where(active, _hct_dr(r, rho[:, None], S[None, :]),
                            torch.zeros_like(r))
        H = (dEdB * c)[:, None] * dterm / r
        grad = grad + torch.einsum("ij,ijk->ik", H + H.T, dv)
        return e, -grad

    def calculate(self, pos, box):
        from .external import TorchExternal

        return TorchExternal(self.energy_fn,
                             energy_forces_fn=self.energy_forces_fn).calculate(pos, box)


def make_gbsa(parameters, mol=None, solvent_dielectric=78.5, solute_dielectric=1.0,
              sa=True, cutoff=None, device=None) -> Optional[GBSA]:
    """The GB/OBC term of an assembled system: radii and screening
    factors from the prmtop's RADII and SCREEN sections when the Molecule
    was read from one (Amber's own GB parameters), else element-based
    mbondi2 defaults (mol.element)."""
    prm = getattr(mol, "prmtop", None) if mol is not None else None
    if prm is not None and "RADII" in prm._sec and "SCREEN" in prm._sec:
        radii, screen = prm.gb_radii, prm.gb_screen
    elif mol is not None and len(getattr(mol, "element", [])):
        radii, screen = default_radii(mol.element)
    else:
        raise ValueError("GBSA needs prmtop RADII/SCREEN sections or element symbols")
    return GBSA(np.asarray(parameters.charges).reshape(-1), radii, screen,
                solvent_dielectric=solvent_dielectric,
                solute_dielectric=solute_dielectric, sa=sa, cutoff=cutoff, device=device)
