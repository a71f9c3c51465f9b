"""Well-tempered metadynamics on one collective variable, the port of
`torchmd_tpu.metadynamics`.

The history-dependent bias lives on a fixed 1-D grid, a device tensor
carried across `run` calls; hills are deposited on the device at every
`stride`-th step of the global step count (chunked `run` calls keep the
stride), and no hill reads anything back to the host: the CV series of a
chunk comes back in one copy at its end.

    B_{t+1}(x) = B_t(x) + w_t exp(-(x - s_t)^2 / 2 sigma^2)
    w_t = height exp(-B_t(s_t) / (kB dT)),   dT = (gamma_b - 1) T

The PMF estimate is F(x) = -(gamma_b / (gamma_b - 1)) B(x) (standard
well-tempered reweighting), shifted to a minimum of 0.

Each step is velocity Verlet with a Langevin kick: `Forces.ef_one` (the
dense pair and bonded kernels on the card, the external included) plus
the bias at the CV by autograd. Reference algorithm: Barducci, Bussi,
Parrinello, PRL 100, 020603 (2008).
"""

from __future__ import annotations

import numpy as np
import torch

from .integrator import TIMEFACTOR, _first_vv, _second_vv
from .units import BOLTZMANN, PICOSEC2TIMEU

__all__ = ["MetaDynamics"]


def _interp_linear(grid, lo, dx, x):
    """Differentiable linear interpolation of a 1-D grid at x (clamped).
    The two grid values come by `index_select` with an index tensor: a
    0-dim tensor as an index would read it to the host."""
    n = grid.shape[0]
    u = torch.clamp((x - lo) / dx, 0.0, n - 1.000001)
    f = torch.floor(u)
    i0 = f.to(torch.long).reshape(1)
    g = grid.index_select(0, torch.cat([i0, i0 + 1]))
    t = u - f
    return g[0] * (1.0 - t) + g[1] * t


class MetaDynamics:
    """Langevin MD plus well-tempered metadynamics on one CV.

    system: a 1-replica System; forces: a built Forces (its ef_one is the
    base potential); cv_fn: a differentiable CV (`torchmd_tpu_torch.cv`);
    grid=(lo, hi, nbins) spans the expected CV range; sigma and height
    are the hill width (CV units) and first height (kcal/mol); stride the
    deposition period in steps; bias_factor the well-tempered gamma
    (np.inf: standard metadynamics). Noise comes from a generator seeded
    with `seed` on the forces' device.
    """

    def __init__(self, system, forces, cv_fn, timestep, T, gamma=1.0,
                 grid=(0.0, 1.0, 200), sigma=0.1, height=0.2, stride=50,
                 bias_factor=10.0, seed=1):
        if system.nreplicas != 1:
            raise ValueError("MetaDynamics drives one replica")
        ext = getattr(forces, "external", None)
        if ext is not None and not hasattr(ext, "energy_fn"):
            raise ValueError(
                "MetaDynamics needs an external potential with energy_fn; a "
                "host-side external cannot join the device loop")
        self.system = system
        self.forces = forces
        self.cv_fn = cv_fn
        self.dt = timestep / TIMEFACTOR
        self.T = float(T)
        self.gamma = gamma / PICOSEC2TIMEU
        lo, hi, nbins = grid
        self.lo, self.hi, self.nbins = float(lo), float(hi), int(nbins)
        self.dx = (self.hi - self.lo) / (self.nbins - 1)
        self.sigma = float(sigma)
        self.height = float(height)
        self.stride = int(stride)
        self.bias_factor = float(bias_factor)
        self.device, self.dtype = forces.device, forces.dtype
        masses = np.asarray(forces.par.masses, dtype=np.float64).reshape(-1, 1)
        self.masses = torch.as_tensor(masses, dtype=self.dtype, device=self.device)
        self.vcoeff = torch.sqrt(2.0 * self.gamma / self.masses * BOLTZMANN * self.T
                                 * self.dt)
        self.bias = torch.zeros(self.nbins, dtype=self.dtype, device=self.device)
        self.xs = self.lo + self.dx * torch.arange(self.nbins, dtype=self.dtype,
                                                   device=self.device)
        self.nhills = 0
        self._step_count = 0
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def _total_e(self, pos, box, box_ef, bias):
        """(Epot, forces): ef_one and the bias at the CV by autograd."""
        pot, frc = self.forces.ef_one(pos, box_ef)
        e = sum(pot.values())
        with torch.enable_grad():
            p = pos.detach().requires_grad_(True)
            eb = _interp_linear(bias, self.lo, self.dx, self.cv_fn(p, box))
            (gb,) = torch.autograd.grad(eb, p)
        return e + eb.detach(), frc - gb

    def _deposits_after(self, i):
        """A hill after global step i (0-based): a host integer decides, so
        no hill reads the device."""
        return (i + 1) % self.stride == 0

    def _deposit(self, bias, pos, box):
        """One hill at the CV of `pos`, on the device."""
        s = self.cv_fn(pos, box)
        w = torch.full((), self.height, dtype=bias.dtype, device=bias.device)
        if np.isfinite(self.bias_factor):
            kT_dT = BOLTZMANN * (self.bias_factor - 1.0) * self.T
            w = w * torch.exp(-_interp_linear(bias, self.lo, self.dx, s) / kT_dT)
        return bias + w * torch.exp(-0.5 * ((self.xs - s) / self.sigma) ** 2)

    def run(self, niter):
        """Advance `niter` steps; returns the CV series of the chunk."""
        s = self.system
        box_np = np.asarray(s.box_diag, np.float64)[0]
        box = torch.as_tensor(box_np, dtype=self.dtype, device=self.device)
        box_ef = box if np.any(box_np != 0) else None
        pos, vel, frc = (torch.as_tensor(a[0], dtype=self.dtype, device=self.device)
                         for a in (s.pos, s.vel, s.forces))
        m, dt, bias = self.masses, self.dt, self.bias
        step0 = self._step_count
        cvs = []
        with torch.no_grad():
            for i in range(step0, step0 + int(niter)):
                pos, vel = _first_vv(pos, vel, frc, m, dt)
                _, frc = self._total_e(pos, box, box_ef, bias)
                noise = torch.randn(vel.shape, generator=self.generator,
                                    device=self.device, dtype=self.dtype)
                vel = vel - self.gamma * vel * dt + noise * self.vcoeff
                vel = _second_vv(vel, frc, m, dt)
                if self._deposits_after(i):
                    bias = self._deposit(bias, pos, box)
                cvs.append(self.cv_fn(pos, box))
        self.bias = bias
        s.pos[0] = pos.cpu().numpy()
        s.vel[0] = vel.cpu().numpy()
        s.forces[0] = frc.cpu().numpy()
        self._step_count = step0 + int(niter)
        self.nhills += self._step_count // self.stride - step0 // self.stride
        return torch.stack(cvs).cpu().numpy()

    def free_energy(self):
        """(grid x, PMF estimate in kcal/mol, shifted to a minimum of 0).
        Well-tempered: F = -(gamma_b / (gamma_b - 1)) B; standard: F = -B."""
        b = self.bias.detach().cpu().numpy().astype(np.float64)
        if np.isfinite(self.bias_factor):
            f = -self.bias_factor / (self.bias_factor - 1.0) * b
        else:
            f = -b
        xs = self.lo + self.dx * np.arange(self.nbins)
        return xs, f - f.min()
