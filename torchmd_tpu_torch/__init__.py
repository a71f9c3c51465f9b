"""torchmd_tpu_torch: the PyTorch + CUDA port of torchmd-tpu.

Beside the JAX package `torchmd_tpu`, which stays the reference, this
package runs the same molecular dynamics on torch tensors, with
hand-written CUDA kernels for the hot paths on an NVIDIA Hopper GPU
(`torchmd_tpu_torch.ops`: the dense pair kernel, the fused bonded kernel,
the cell-list and column pair kernels and the PME spread and ik-gather
kernels). It
has its own copy of the numpy front end (`io`, `forcefields`,
`parameters`, `units`) and imports neither jax nor the JAX package.
Entry points run on the CUDA card unless given `device="cpu"`.

Quick start (a TIP4P/2005 water box with PME, SETTLE, virtual sites and a
Nose-Hoover chain; `water.top` is a GROMACS topology, `coords` (N, 3) in
Angstrom, `L` the cubic box edge):

    import numpy as np
    from torchmd_tpu_torch import (Forces, ForceField, Integrator, Molecule,
                                   Parameters, System, maxwell_boltzmann)

    mol = Molecule("water.top")
    ff = ForceField.create(mol, "water.top")
    terms = ["bonds", "lj", "electrostatics"]
    par = Parameters(ff, mol, terms, precision="single")
    forces = Forces(par, terms=terms, precision="single", cutoff=8.5,
                    elec="ewald")                 # cell list + PME on the card
    system = System(mol.numAtoms, 1, "single")
    system.set_positions(coords)
    system.set_box(np.full(3, L))
    system.set_velocities(maxwell_boltzmann(par.masses, 300, seed=3))
    integ = Integrator(system, forces, 2.0, T=300, thermostat="nhc",
                       constraints="settle")
    Ekin, Epot, T = integ.step(niter=100)

NPT (MTK barostat, 1 bar, on the column kernel on the card):

    integ = Integrator(system, forces, 2.0, T=300, thermostat="nhc",
                       constraints="settle",
                       barostat=MTKBarostat(1.0, 300.0, tau_fs=2000.0))
"""

__version__ = "0.1.0"

__all__ = [
    "systems", "potentials", "bonded", "forces", "integrator", "interop",
    "ops", "io", "forcefields", "parameters", "units", "neighbors", "ewald",
    "vsites", "constraints", "thermostats", "columns", "barostat",
    # convenience re-exports (lazy)
    "Molecule", "ForceField", "AmberForcefield", "GromacsForcefield",
    "Parameters", "System", "Forces", "Integrator", "maxwell_boltzmann",
    "ffparams_from_numpy", "MTKBarostat",
]

_LAZY = {
    "Molecule": ("torchmd_tpu_torch.io", "Molecule"),
    "ForceField": ("torchmd_tpu_torch.forcefields", "ForceField"),
    "AmberForcefield": ("torchmd_tpu_torch.forcefields.ff_amber", "AmberForcefield"),
    "GromacsForcefield": ("torchmd_tpu_torch.forcefields.ff_gromacs",
                          "GromacsForcefield"),
    "Parameters": ("torchmd_tpu_torch.parameters", "Parameters"),
    "System": ("torchmd_tpu_torch.systems", "System"),
    "Forces": ("torchmd_tpu_torch.forces", "Forces"),
    "Integrator": ("torchmd_tpu_torch.integrator", "Integrator"),
    "maxwell_boltzmann": ("torchmd_tpu_torch.integrator", "maxwell_boltzmann"),
    "ffparams_from_numpy": ("torchmd_tpu_torch.interop", "ffparams_from_numpy"),
    "MTKBarostat": ("torchmd_tpu_torch.barostat", "MTKBarostat"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'torchmd_tpu_torch' has no attribute {name!r}")
