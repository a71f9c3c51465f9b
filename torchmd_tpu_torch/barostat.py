"""The Martyna-Tobias-Klein (MTK) extended-system barostat.

Counterpart of `torchmd_tpu.barostat.MTKBarostat`: true NPT dynamics with
a box that fluctuates inside the integrator's step loop. The barostat
degree of freedom eps_k = ln L_k has velocity v_eps and mass
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

The Monte Carlo barostats of the JAX package are not ported yet: the
Integrator raises NotImplementedError for them.
"""

from __future__ import annotations

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
