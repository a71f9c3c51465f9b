"""Thermodynamic observables: virial and instantaneous pressure (the
port's counterpart of `torchmd_tpu.observables`).

The virial is computed by `torch.autograd` through a uniform scaling of
coordinates AND box,

    W = -dU(lambda*pos, lambda*box)/dlambda |_{lambda=1}

which is exact for every differentiable term without per-term virial
formulas. `pressure` takes the differentiable torch-op energy of the
bonded and dense nonbonded terms (`potentials.compute_potentials`, with
virtual sites snapped at the scaled geometry) and of an external's
`energy_fn`. The terms with an analytic virial add it, as the NPT
integrator composes them (`Integrator._npt_ef_vir`): on the cell path
the cell or column kernel's per-axis pair virial, and PME's
(`PmeRecip.energy_forces_virial`), both at the snapped geometry with the
site correction -sum F (r - dr/ds). Pressure: P = (2K + W) / (3V).
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
        if not e.requires_grad:   # no term left to differentiate
            return torch.zeros((), dtype=pos.dtype, device=pos.device)
        (dUdl,) = torch.autograd.grad(e, lmbda)
    return -dUdl


def _total_energy_fn(forces, nonbonded=True):
    """The differentiable energy of one conformation (without PME's
    reciprocal part, and without the pair terms when `nonbonded` is
    False: the analytic virials carry those)."""
    from .potentials import compute_potentials
    from .vsites import apply_vsites

    ext = getattr(forces.external, "energy_fn", None)
    if forces.external is not None and ext is None:
        raise NotImplementedError(
            "pressure needs the external's energy_fn (a calculate-only "
            "external gives no virial)")

    def etot_one(pos, box):
        if forces.vsites:
            pos = apply_vsites(forces.vsites, pos, box)
        pot = compute_potentials(forces.ffparams, pos, box, forces.config,
                                 nonbonded=nonbonded)
        e = sum(pot.values()) if pot else torch.zeros((), dtype=pos.dtype,
                                                     device=pos.device)
        if ext is not None:
            e = e + ext(pos, box).reshape(())
        return e

    return etot_one


def _analytic_virial(forces, pos, box, cell):
    """W of the terms with an analytic per-axis virial (the cell or column
    kernel's pairs when `cell`, PME's reciprocal part), at the snapped
    geometry with the site correction."""
    from .vsites import apply_vsites_scaling

    p2 = pos
    if forces.vsites:
        p2, tangent = apply_vsites_scaling(forces.vsites, pos, box)
    frc, vir = torch.zeros_like(pos), torch.zeros_like(box)
    if cell:
        kern = forces._cell_kernel
        _, frc, vir = kern.energy_forces_virial(p2, box, kern.build(p2, box))
    if forces._ewald is not None:
        _, f_r, v_r = forces._ewald.energy_forces_virial(p2, box, "exact")
        frc, vir = frc + f_r, vir + v_r
    if forces.vsites:
        vir = vir - (frc * (p2 - tangent)).sum(0)
    return vir.sum()


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
    cell = forces.nb_path == "cell"
    etot_one = _total_energy_fn(forces, nonbonded=not cell)
    boxd = torch.as_tensor(box, dtype=dtype, device=dev)
    W = []
    for p, b in zip(pos, boxd):
        w = virial(etot_one, p, b)
        if cell or forces._ewald is not None:
            w = w + _analytic_virial(forces, p, b, cell)
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
