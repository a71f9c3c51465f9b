"""Thermodynamic observables: virial and instantaneous pressure (the
port's counterpart of `torchmd_tpu.observables`).

The virial is computed by `torch.autograd` through a uniform scaling of
coordinates AND box,

    W = -dU(lambda*pos, lambda*box)/dlambda |_{lambda=1}

which is exact for every differentiable term without per-term virial
formulas. `pressure` takes the differentiable torch-op energy of the
bonded and dense nonbonded terms (`potentials.compute_potentials`, with
virtual sites snapped at the scaled geometry) and of an external's
`energy_fn`, and PME's analytic virial (`PmeRecip.energy_forces_virial`).
Pressure: P = (2K + W) / (3V).
"""

from __future__ import annotations

import numpy as np
import torch

from .units import BOLTZMANN

# kcal/mol/A^3 -> bar
KCALMOL_A3_TO_BAR = 1.0 / (1.0e5 * 1.0e-30 * 6.02214076e23 / 4184.0)


def virial(efn_one, pos, box):
    """-dU/dlambda for one conformation. efn_one(pos, box) -> scalar
    tensor, differentiable in both."""
    with torch.enable_grad():
        lmbda = torch.ones((), dtype=pos.dtype, device=pos.device, requires_grad=True)
        e = efn_one(pos.detach() * lmbda, None if box is None else box * lmbda)
        (dUdl,) = torch.autograd.grad(e, lmbda)
    return -dUdl


def _total_energy_fn(forces):
    """The differentiable energy of one conformation (without PME's
    reciprocal part, whose virial is analytic)."""
    from .potentials import compute_potentials
    from .vsites import apply_vsites

    has_nb = any(t in forces.energies for t in forces.nonbonded)
    if has_nb and forces.ffparams.nb_mask is None:
        raise NotImplementedError(
            "pressure on the cell-list path (deferred exclusion mask) is not "
            "ported yet; its virial is the NPT integrator's")
    ext = getattr(forces.external, "energy_fn", None)
    if forces.external is not None and ext is None:
        raise NotImplementedError(
            "pressure needs the external's energy_fn (a calculate-only "
            "external gives no virial)")

    def etot_one(pos, box):
        if forces.vsites:
            pos = apply_vsites(forces.vsites, pos, box)
        pot = compute_potentials(forces.ffparams, pos, box, forces.config)
        e = sum(pot.values()) if pot else torch.zeros((), dtype=pos.dtype,
                                                     device=pos.device)
        if ext is not None:
            e = e + ext(pos, box).reshape(())
        return e

    return etot_one


def pressure(forces, system, units="bar"):
    """Instantaneous pressure per replica from the current System state.
    Requires a periodic box."""
    from .integrator import kinetic_energy

    box = np.asarray(system.box_diag, dtype=np.float64)
    if np.any(box <= 0):
        raise ValueError("Pressure requires a periodic box")
    dev, dtype = forces.device, forces.dtype
    pos = torch.as_tensor(np.asarray(system.pos), dtype=dtype, device=dev)
    forces.prepare(pos, box)
    etot_one = _total_energy_fn(forces)
    boxd = torch.as_tensor(box, dtype=dtype, device=dev)
    W = []
    for p, b in zip(pos, boxd):
        w = virial(etot_one, p, b)
        if forces._ewald is not None:
            w = w + forces._ewald.energy_forces_virial(p, b, "exact")[2].sum()
        W.append(w)
    W = torch.stack(W)
    masses = torch.as_tensor(np.asarray(forces.par.masses).reshape(-1, 1),
                             dtype=dtype, device=dev)
    K = kinetic_energy(masses, torch.as_tensor(np.asarray(system.vel), dtype=dtype,
                                               device=dev))[:, 0]
    V = boxd.prod(dim=1)
    P = ((2.0 * K + W) / (3.0 * V)).detach().cpu().numpy().astype(np.float64)
    return P * KCALMOL_A3_TO_BAR if units == "bar" else P


def ideal_gas_pressure(natoms, T, volume, units="bar"):
    """NkT/V reference value."""
    p = natoms * BOLTZMANN * T / volume
    return p * KCALMOL_A3_TO_BAR if units == "bar" else p
