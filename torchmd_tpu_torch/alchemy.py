"""Alchemical free energies: soft-core decoupling, TI and FEP/BAR, the
port of `torchmd_tpu.alchemy`.

The coupling energy is a torch function of (positions, box, lambda):
dU/dlambda is one autograd pass (thermodynamic integration), stored
frames re-evaluate at other lambdas (FEP, BAR), and the term joins every
force evaluation as the external potential (`energy_fn`).

Scheme (standard decoupling): alchemical atoms keep their intramolecular
interactions; only the crossing pairs (alchemical x environment) are
lambda-coupled, with Beutler soft-core LJ

    E_lj = 4 eps lam [ (alpha (1-lam) + (r/sigma)^6)^-2
                       - (alpha (1-lam) + (r/sigma)^6)^-1 ]

and linearly scaled electrostatics on the soft-core distance (the base
force field's cutoff, reaction field or Ewald settings).
`make_alchemical` removes the crossing pairs from the base nonbonded
mask, rebuilds the evaluators (on the kernel path the pair kernel reads
the mask as the tile exclusion words of `ops.nonbonded.tile_exclusions`,
made anew from the edited mask there: words left from the old mask would
count every crossing pair twice) and attaches the coupling as the
external.
"""

from __future__ import annotations

import numpy as np
import torch

from .potentials import wrap_displacement
from .units import ELEC_FACTOR

__all__ = ["AlchemicalCoupling", "make_alchemical", "ti_integrate", "fep_exponential",
           "bar"]


class AlchemicalCoupling:
    """Lambda-coupled crossing-pair interactions (soft-core LJ and scaled
    electrostatics). An external potential (`energy_fn(pos, box)`), so
    `Forces(..., external=coupling)` adds it to every evaluation with
    forces by autograd. `env_atoms` restricts the environment (several
    lambda sites: the other sites' atoms are neither)."""

    def __init__(self, ffparams, cfg, alch_atoms, lam=1.0, alpha=0.5,
                 softcore_power=1, env_atoms=None):
        natoms = int(ffparams.charges.shape[0])
        alch = np.zeros(natoms, dtype=bool)
        alch[np.asarray(alch_atoms, dtype=np.int64)] = True
        if env_atoms is None:
            env = ~alch
        else:
            env = np.zeros(natoms, dtype=bool)
            env[np.asarray(env_atoms, dtype=np.int64)] = True
            if np.any(env & alch):
                raise ValueError("env_atoms overlap alch_atoms")
        ai, ei = np.flatnonzero(alch), np.flatnonzero(env)
        dev = ffparams.charges.device
        self.device = dev
        self.alch_idx = torch.as_tensor(ai, device=dev)
        self.env_idx = torch.as_tensor(ei, device=dev)
        self.lam = float(lam)
        self.alpha = float(alpha)
        self.softcore_power = int(softcore_power)
        self.cfg = cfg

        # static per-pair tables on the (n_alch, n_env) crossing block
        nb_mask = ffparams.nb_mask.cpu().numpy().astype(bool)
        self.pair_mask = torch.as_tensor(nb_mask[np.ix_(ai, ei)], device=dev)
        q = ffparams.charges.double().cpu().numpy()
        qq = ELEC_FACTOR * q[ai][:, None] * q[ei][None, :]
        ti = ffparams.mapped_atom_types.cpu().numpy()
        ta, te = ti[ai], ti[ei]
        if ffparams.lj_ab is not None:
            # NBFIX tables: per-pair sigma^6 and eps from the A/B the base
            # path uses (A = 4 eps sig^12, B = 4 eps sig^6), so lam = 1 is
            # the base system exactly
            A = ffparams.lj_ab[0].double().cpu().numpy()[ta[:, None], te[None, :]]
            B = ffparams.lj_ab[1].double().cpu().numpy()[ta[:, None], te[None, :]]
            safe_B = np.where(B > 0, B, 1.0)
            sig6 = np.where(B > 0, A / safe_B, 1.0)
            eps = np.where(B > 0, B * B / np.maximum(4.0 * A, 1e-300), 0.0)
        else:
            # Lorentz-Berthelot by type. The JAX package indexes its
            # per-atom rows lj[ti] with the type ids again
            # (torchmd_tpu/alchemy.py:87-89): right for one LJ type, wrong
            # for several (ROADMAP.md section 3)
            lj = ffparams.lj_params.double().cpu().numpy()
            sig = 0.5 * (lj[ta, 0][:, None] + lj[te, 0][None, :])
            eps = np.sqrt(np.abs(lj[ta, 1])[:, None] * np.abs(lj[te, 1])[None, :])
            sig6 = sig ** 6
        # sigma = 0 pairs (two hydroxyl hydrogens, say) have no LJ in the
        # base force field: eps 0 and a unit sigma^6 for the soft-core LJ,
        # whose r^6 / sigma^6 would otherwise give 0 * inf forces; the
        # soft-core distance keeps the true sigma^6 (0: r itself)
        lj_sig6 = np.where(sig6 > 0, sig6, 1.0)
        eps = np.where(sig6 > 0, eps, 0.0)
        self._f64 = {"qq": qq, "sigma6": sig6, "lj_sigma6": lj_sig6, "eps": eps}
        self._tables = {}

    def _table(self, dtype):
        """(qq, sigma^6, the LJ's sigma^6, eps) of the crossing block at
        `dtype`."""
        if dtype not in self._tables:
            self._tables[dtype] = tuple(
                torch.as_tensor(self._f64[k], dtype=dtype, device=self.device)
                for k in ("qq", "sigma6", "lj_sigma6", "eps"))
        return self._tables[dtype]

    def energy_lambda(self, pos, box, lam):
        """Crossing-pair coupling energy at lambda `lam` (1 coupled, 0
        decoupled); differentiable in pos (forces) and in a tensor lam
        (TI)."""
        cfg = self.cfg
        dtype = pos.dtype
        qq, sigma6, lj_sigma6, eps = self._table(dtype)
        lam = torch.as_tensor(lam, dtype=dtype, device=pos.device)
        if box is not None:
            box = torch.as_tensor(box, dtype=dtype, device=pos.device).reshape(-1)[:3]
        dv = wrap_displacement(pos[self.alch_idx][:, None, :] - pos[self.env_idx][None, :, :],
                               box)
        d2 = (dv * dv).sum(-1)
        mask = self.pair_mask
        if cfg.cutoff is not None:
            mask = mask & (d2 <= cfg.cutoff * cfg.cutoff)
        fmask = mask.to(dtype)
        d2 = torch.where(mask, d2, torch.ones_like(d2))

        # Beutler soft-core LJ
        lam_sc = lam ** self.softcore_power
        d6 = d2 * d2 * d2
        inv = 1.0 / (self.alpha * (1.0 - lam) + d6 / lj_sigma6)
        e_lj = 4.0 * eps * lam_sc * (inv * inv - inv)
        if cfg.switch_dist is not None and cfg.cutoff is not None:
            dist = torch.sqrt(d2)
            t = (dist - cfg.switch_dist) / (cfg.cutoff - cfg.switch_dist)
            sw = 1.0 + t * t * t * (-10.0 + t * (15.0 - t * 6.0))
            e_lj = torch.where(dist > cfg.switch_dist, e_lj * sw, e_lj)

        # linearly scaled electrostatics on the soft-core distance
        # r_sc = (alpha (1-lam) sigma^6 + r^6)^(1/6): finite at overlap,
        # exactly r at lam = 1
        dist = (self.alpha * (1.0 - lam) * sigma6 + d6) ** (1.0 / 6.0)
        rinv = 1.0 / dist
        if cfg.ewald_alpha is not None:
            pot_e = qq * torch.special.erfc(cfg.ewald_alpha * dist) * rinv
        elif cfg.rfa and cfg.cutoff is not None:
            den = 2.0 * cfg.solvent_dielectric + 1.0
            krf = (1.0 / cfg.cutoff ** 3) * (cfg.solvent_dielectric - 1.0) / den
            crf = (1.0 / cfg.cutoff) * (3.0 * cfg.solvent_dielectric) / den
            pot_e = qq * (rinv + krf * dist * dist - crf)
        else:
            pot_e = qq * rinv
        return ((e_lj + lam * pot_e) * fmask).sum()

    def energy_fn(self, pos, box):
        """External-potential protocol: the energy at the current lambda."""
        return self.energy_lambda(pos, box, self.lam)

    def dudl(self, pos, box, lam=None):
        """dU/dlambda at (pos, box): the TI integrand sample."""
        lam = self.lam if lam is None else lam
        with torch.enable_grad():
            lt = torch.tensor(float(lam), dtype=pos.dtype, device=pos.device,
                              requires_grad=True)
            (g,) = torch.autograd.grad(self.energy_lambda(pos.detach(), box, lt), lt)
        return g

    def energies_over_frames(self, frames, boxes, lam):
        """Coupling energy of stored frames (F, N, 3) with their boxes
        (F, 3) re-evaluated at `lam`: the FEP/BAR building block."""
        with torch.no_grad():
            return torch.stack([self.energy_lambda(p, None if boxes is None else boxes[f], lam)
                                for f, p in enumerate(frames)])


def _require_masked_nonbonded(forces):
    """Alchemical constructions edit the dense nb_mask: the cell and
    column kernels read only the bonds/angles/1-4 exclusion table and
    would count every crossing pair twice, so a Forces that can take the
    cell path raises. A built Verlet kernel holds the mask as it was
    and is dropped (the next `prepare` builds it from the edited one)."""
    if getattr(forces, "cell_requested", False) or getattr(forces, "cell_auto", False):
        raise NotImplementedError(
            "alchemical coupling requires a nonbonded path driven by the "
            "dense mask (dense/kernel/verlet); the cell-list kernel does "
            "not consult nb_mask and would double-count crossing pairs")
    from .neighbors import VerletKernel

    if isinstance(getattr(forces, "_cell_kernel", None), VerletKernel):
        forces._cell_kernel = None


def _cut_crossing(forces, alch, env):
    """Remove the (alch x env) pairs from forces' nb_mask, both ways."""
    mask = forces.ffparams.nb_mask.clone()
    a = torch.as_tensor(np.asarray(alch, np.int64), device=mask.device)
    e = torch.as_tensor(np.asarray(env, np.int64), device=mask.device)
    mask[a[:, None], e[None, :]] = False
    mask[e[:, None], a[None, :]] = False
    forces.ffparams = forces.ffparams._replace(nb_mask=mask)


def make_alchemical(forces, alch_atoms, lam=1.0, alpha=0.5, softcore_power=1):
    """Turn a built `Forces` into an alchemically coupled system: the
    crossing pairs leave the base nonbonded mask, the evaluators are
    rebuilt (the pair kernel's exclusion words with them), and the
    coupling, returned, becomes the external potential."""
    _require_masked_nonbonded(forces)
    coupling = AlchemicalCoupling(forces.ffparams, forces.config, alch_atoms, lam=lam,
                                  alpha=alpha, softcore_power=softcore_power)
    _cut_crossing(forces, coupling.alch_idx.cpu().numpy(), coupling.env_idx.cpu().numpy())
    forces.external = coupling
    forces._build_evaluators()
    return coupling


# ----------------------------------------------------------------------
# Free-energy estimators (host numpy; kcal/mol)
# ----------------------------------------------------------------------

def ti_integrate(lambdas, dudl_means):
    """Thermodynamic integration: the trapezoid over <dU/dlambda>(lambda)."""
    lambdas = np.asarray(lambdas, np.float64)
    dudl_means = np.asarray(dudl_means, np.float64)
    order = np.argsort(lambdas)
    x, y = lambdas[order], dudl_means[order]
    return float(np.sum(0.5 * (y[1:] + y[:-1]) * np.diff(x)))


def fep_exponential(du, kT):
    """Zwanzig exponential averaging: dF = -kT ln <exp(-dU/kT)>."""
    du = np.asarray(du, np.float64) / kT
    m = du.min()
    return float(kT * (m - np.log(np.mean(np.exp(-(du - m))))))


def bar(w_f, w_r, kT, tol=1e-10, maxiter=500):
    """Bennett acceptance ratio for forward work w_f (0 -> 1) and reverse
    work w_r (1 -> 0), in kcal/mol; dF by bisection on the
    self-consistent BAR equation."""
    w_f = np.asarray(w_f, np.float64) / kT
    w_r = np.asarray(w_r, np.float64) / kT
    M = np.log(len(w_f) / len(w_r))

    def fermi(x):
        return 1.0 / (1.0 + np.exp(np.clip(x, -500, 500)))

    def resid(df):
        return (np.log(np.sum(fermi(M + w_f - df)) + 1e-300)
                - np.log(np.sum(fermi(-M + w_r + df)) + 1e-300))

    lo, hi = -1e4, 1e4
    r_lo = resid(lo)
    for _ in range(maxiter):
        mid = 0.5 * (lo + hi)
        r = resid(mid)
        if abs(r) < tol or (hi - lo) < tol:
            return float(mid * kT)
        if (r > 0) == (r_lo > 0):
            lo, r_lo = mid, r
        else:
            hi = mid
    return float(0.5 * (lo + hi) * kT)
