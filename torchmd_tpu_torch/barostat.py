"""Barostats: the Martyna-Tobias-Klein (MTK) extended system and the
Monte Carlo volume moves.

Counterpart of `torchmd_tpu.barostat`. `MTKBarostat` gives true NPT
dynamics with a box that fluctuates inside the integrator's step loop.
The barostat degree of freedom eps_k = ln L_k has velocity v_eps and mass
W = (Nf + 3) kT tau_p^2 (split over the three axes); it is driven by

    G_k = 2K_k + 2K/Nf + W_vir,k - V P_ext  [+ gamma A on x/y, membrane]

then projected on the coupling mode:

  - 'iso'      all three axes tied (the scalar MTK equations),
  - 'aniso'    axes relax independently; `scale_axes` freezes some,
  - 'membrane' x/y tied, z independent, surface tension gamma (bar A).

W_vir,k = -dU(s pos, s box)/ds_k at s = 1: the pair kernels' per-axis
virial plus the PME and the cheap terms' scaling derivatives. Particles
and the barostat each couple to a Nose-Hoover chain; the integrator
(`Integrator(barostat=MTKBarostat(...))`) carries v_eps and the barostat
chain's state. This object holds the static parameters only.

The Monte Carlo barostats (`MonteCarloBarostat`, isotropic;
`MonteCarloAnisotropicBarostat`, one axis a move;
`MonteCarloMembraneBarostat`, x/y tied, z free, with a surface tension)
run between integrator chunks
(`attempt(system, forces)`, as the CLI does after each output period;
`Integrator(barostat=<MC>)` raises ValueError). Each attempt proposes
V' = V + dV with dV ~ U(-dVmax, dVmax), scales each group's centroid (the
plain mean of its atoms, not the mass-weighted centre, so rigid waters and
massless TIP4P sites keep their geometry) and accepts with

    exp(-(dE + P dV + extra - N kT ln(V'/V)) / kT),

N the number of groups (atoms without `group_id`). dVmax self-tunes
toward 25-75 % acceptance. The draws come from the barostat's own
`torch.Generator(seed)` on the CPU (the proposal and the decision are
host values). Both energies are `forces.compute` of device tensors; the
positions are scaled on the device in f64. An accepted move writes
`system.pos` and `system.box`, which the Integrator picks up as host
edits at its next chunk (the cell grid re-boxes through `Forces.prepare`,
PME keeps its mesh and takes the new box); `system.forces` keeps the
forces of the positions before the move, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .units import BOLTZMANN

# 1 bar * A^3 in kcal/mol
BAR_A3_TO_KCALMOL = 1.0e5 * 1.0e-30 * 6.02214076e23 / 4184.0

MODES = ("iso", "aniso", "membrane")


class MTKBarostat:
    is_dynamic = True

    def __init__(self, pressure_bar, temperature, tau_fs=None, nchain=3,
                 mode="iso", surface_tension=0.0,
                 scale_axes=(True, True, True)):
        if mode not in MODES:
            raise ValueError(f"Unknown MTK mode: {mode}")
        self.pressure = float(pressure_bar) * BAR_A3_TO_KCALMOL
        self.pressure_bar = float(pressure_bar)
        self.T = float(temperature)
        self.tau_fs = None if tau_fs is None else float(tau_fs)
        self.nchain = int(nchain)
        self.mode = mode
        self.gamma_st = float(surface_tension) * BAR_A3_TO_KCALMOL
        self.scale_axes = tuple(bool(b) for b in scale_axes)
        if mode == "aniso" and not any(self.scale_axes):
            raise ValueError("at least one axis must be scalable")


class MonteCarloBarostat:
    """Isotropic Monte Carlo volume moves (the OpenMM MonteCarloBarostat
    scheme). `group_id` (natoms,) ints: atoms scaled together as one unit
    (molecules); without it every atom is a unit."""

    def __init__(self, pressure_bar, temperature, group_id=None, seed=0,
                 dv_max=None):
        self.pressure = pressure_bar * BAR_A3_TO_KCALMOL  # kcal/mol/A^3
        self.T = temperature
        self.group_id = None if group_id is None else np.asarray(group_id, np.int64)
        self.generator = torch.Generator().manual_seed(int(seed))
        self.dv_max = dv_max  # A^3; set on the first attempt
        self.n_attempted = 0
        self.n_accepted = 0
        self._groups = {}

    # ------------------------------------------------------------------
    def uniform(self, n):
        """(n,) U(0, 1) draws from the barostat's generator."""
        return torch.rand(n, generator=self.generator, dtype=torch.float64).numpy()

    def _group_tensors(self, device):
        """(group ids, 1 / atoms per group) on `device`, built once."""
        if device not in self._groups:
            gid = torch.as_tensor(self.group_id, device=device)
            counts = np.bincount(self.group_id).astype(np.float64)
            self._groups[device] = (gid, torch.as_tensor(
                1.0 / np.maximum(counts, 1.0), device=device)[:, None])
        return self._groups[device]

    def _scale_positions(self, pos, scale):
        """Each group's centroid scaled by `scale` ((R, 1, 3)), its atoms
        moved with it rigidly. `pos` (R, N, 3) float64 tensor."""
        if self.group_id is None:
            return pos * scale
        gid, inv_count = self._group_tensors(pos.device)
        sums = torch.zeros((pos.shape[0], inv_count.shape[0], 3), dtype=pos.dtype,
                           device=pos.device).index_add_(1, gid, pos)
        centroid = sums * inv_count
        return pos + (scale - 1.0) * centroid[:, gid, :]

    def _n_units(self, natoms):
        if self.group_id is None:
            return natoms
        return int(self.group_id.max()) + 1

    def _propose(self, box):
        """Per replica (scale (R, 3), dV (R,), extra work (R,)) for one
        move of the (R, 3) box. The variants override it."""
        V = np.prod(box, axis=1)
        dv = (self.uniform(len(box)) * 2 - 1) * self.dv_max
        s = ((V + dv) / V) ** (1.0 / 3.0)
        return np.repeat(s[:, None], 3, axis=1), dv, np.zeros(len(box))

    def attempt(self, system, forces, proposal=None, uniform=None):
        """One move on a System; each replica accepts or rejects on its
        own. `proposal` ((scale, dV, extra)) and `uniform` ((R,)) replace
        the generator's draws (tests feed both packages the same ones).
        Returns the (R,) accept flags; `self.last` keeps the attempt's
        energies before and after the move, its work, scale and dV."""
        box = system.box_diag
        if np.any(box <= 0):
            raise ValueError("Barostat requires a periodic box")
        V = np.prod(box, axis=1)
        if self.dv_max is None:
            self.dv_max = 0.01 * float(V[0])
        nrep = system.nreplicas
        pos = torch.as_tensor(np.asarray(system.pos), dtype=torch.float64,
                              device=forces.device)
        e_old = np.asarray(forces.compute(pos, system.box), np.float64)

        scale, dv, extra = self._propose(box) if proposal is None else proposal
        scale, dv, extra = (np.asarray(a, np.float64) for a in (scale, dv, extra))
        pos_new = self._scale_positions(
            pos, torch.as_tensor(scale, device=pos.device)[:, None, :])
        box_new = box * scale
        e_new = np.asarray(forces.compute(pos_new, box_new), np.float64)

        kT = BOLTZMANN * self.T
        w = ((e_new - e_old) + self.pressure * dv + extra
             - self._n_units(system.natoms) * kT * np.log((V + dv) / V))
        u = self.uniform(nrep) if uniform is None else np.asarray(uniform)
        accept = u < np.exp(np.minimum(-w / kT, 0.0))
        self.last = {"e_old": e_old, "e_new": e_new, "work": w, "scale": scale,
                     "dv": dv}

        if accept.any():
            new = pos_new.cpu().numpy()
            for r in np.flatnonzero(accept):
                system.pos[r] = new[r].astype(system.pos.dtype)
                np.fill_diagonal(system.box[r], box_new[r].astype(system.box.dtype))
        self.n_attempted += nrep
        self.n_accepted += int(accept.sum())
        # step size toward ~50 % acceptance (the OpenMM heuristic)
        if self.n_attempted >= 10:
            rate = self.n_accepted / self.n_attempted
            if rate < 0.25:
                self.dv_max /= 1.1
                self.n_attempted = self.n_accepted = 0
            elif rate > 0.75:
                self.dv_max *= 1.1
                self.n_attempted = self.n_accepted = 0
        return accept


class MonteCarloAnisotropicBarostat(MonteCarloBarostat):
    """Anisotropic NPT: each attempt scales one randomly chosen enabled
    box axis, so the three box lengths relax independently. `pressure_bar`
    may be per axis; the work takes that axis's pressure."""

    def __init__(self, pressure_bar, temperature, group_id=None, seed=0,
                 dv_max=None, scale_axes=(True, True, True)):
        super().__init__(np.mean(np.atleast_1d(pressure_bar)), temperature,
                         group_id=group_id, seed=seed, dv_max=dv_max)
        p = np.broadcast_to(np.atleast_1d(np.asarray(pressure_bar, np.float64)), (3,))
        self.pressure_axes = p * BAR_A3_TO_KCALMOL
        self.scale_axes = np.asarray(scale_axes, bool)
        if not self.scale_axes.any():
            raise ValueError("at least one axis must be scalable")

    def _propose(self, box):
        V = np.prod(box, axis=1)
        nrep = len(box)
        enabled = np.flatnonzero(self.scale_axes)
        axis = enabled[np.minimum((self.uniform(nrep) * len(enabled)).astype(np.int64),
                                  len(enabled) - 1)]
        dv = (self.uniform(nrep) * 2 - 1) * self.dv_max
        scale = np.ones((nrep, 3))
        scale[np.arange(nrep), axis] = (V + dv) / V
        return scale, dv, (self.pressure_axes[axis] - self.pressure) * dv


class MonteCarloMembraneBarostat(MonteCarloBarostat):
    """Semi-isotropic NPT for membranes: x/y scale together, z on its own,
    with a constant surface-tension term, w = dE + P dV - gamma dA -
    N kT ln(V'/V); gamma in bar*A (1 bar*A = 10 mN/m). zmode: 'free' (z
    fluctuates under P), 'fixed' (z never scales) or 'volume' (z rescales
    to keep V: area moves only)."""

    def __init__(self, pressure_bar, temperature, surface_tension=0.0,
                 group_id=None, seed=0, dv_max=None, zmode="free"):
        super().__init__(pressure_bar, temperature, group_id=group_id,
                         seed=seed, dv_max=dv_max)
        if zmode not in ("free", "fixed", "volume"):
            raise ValueError(f"Unknown zmode: {zmode}")
        self.gamma = surface_tension * BAR_A3_TO_KCALMOL  # kcal/mol/A^2
        self.zmode = zmode

    def _propose(self, box):
        V = np.prod(box, axis=1)
        A = box[:, 0] * box[:, 1]
        nrep = len(box)
        dv = (self.uniform(nrep) * 2 - 1) * self.dv_max
        # proposals with V' <= 0 become identity moves (symmetric, so
        # detailed balance holds; dVmax self-tunes far below V)
        dv = np.where(dv <= -0.9 * V, 0.0, dv)
        scale = np.ones((nrep, 3))
        if self.zmode == "volume":
            s_xy = (1.0 + dv / V) ** 0.5
            scale[:, 0] = scale[:, 1] = s_xy
            scale[:, 2] = 1.0 / (s_xy * s_xy)
            return scale, np.zeros(nrep), -self.gamma * A * (s_xy * s_xy - 1.0)
        # alternate xy-area and z-normal moves
        pick_xy = self.uniform(nrep) < 0.5
        if self.zmode == "fixed":
            pick_xy[:] = True
        s_xy = ((V + dv) / V) ** 0.5
        scale[:, 0] = scale[:, 1] = np.where(pick_xy, s_xy, 1.0)
        scale[:, 2] = np.where(pick_xy, 1.0, (V + dv) / V)
        dA = np.where(pick_xy, A * (s_xy * s_xy - 1.0), 0.0)
        return scale, dv, -self.gamma * dA
