"""torchmd_tpu_torch: the PyTorch + CUDA port of torchmd-tpu.

Beside the JAX package `torchmd_tpu`, which stays the reference, this
package runs the same molecular dynamics on torch tensors, with
hand-written CUDA kernels for the hot path on an NVIDIA Hopper GPU (the
dense pair kernel and the fused bonded kernel, `torchmd_tpu_torch.ops`).
It shares the JAX package's numpy-only front end (`torchmd_tpu.io`,
`torchmd_tpu.forcefields`, `torchmd_tpu.parameters`, `torchmd_tpu.units`)
and never imports jax.

Quick start (thrombin-ligand, the slice's main path):

    from torchmd_tpu.io import Molecule
    from torchmd_tpu.forcefields.ff_amber import AmberForcefield
    from torchmd_tpu.parameters import Parameters
    from torchmd_tpu_torch import Forces, System, Integrator, maxwell_boltzmann

    mol = Molecule("structure.prmtop"); mol.read("structure.pdb")
    ff = AmberForcefield(mol, "structure.prmtop")
    terms = ["bonds", "angles", "dihedrals", "impropers", "1-4",
             "electrostatics", "lj"]
    par = Parameters(ff, mol, terms, precision="single")
    forces = Forces(par, terms=terms, precision="single", cutoff=7.3,
                    rfa=True, device="cuda")
    system = System(mol.numAtoms, 1, "single")
    system.set_positions(mol.coords)
    gen = torch.Generator(device="cuda").manual_seed(1)
    system.set_velocities(maxwell_boltzmann(par.masses, 300, generator=gen))
    integ = Integrator(system, forces, 4.0, gamma=0.1, T=300)
    Ekin, Epot, T = integ.step(niter=100)
"""

__version__ = "0.1.0"

__all__ = [
    "systems", "potentials", "bonded", "forces", "integrator", "interop",
    "ops",
    # convenience re-exports (lazy)
    "Molecule", "AmberForcefield", "Parameters", "System", "Forces",
    "Integrator", "maxwell_boltzmann", "ffparams_from_numpy",
]

_LAZY = {
    "Molecule": ("torchmd_tpu.io", "Molecule"),
    "AmberForcefield": ("torchmd_tpu.forcefields.ff_amber", "AmberForcefield"),
    "Parameters": ("torchmd_tpu.parameters", "Parameters"),
    "System": ("torchmd_tpu_torch.systems", "System"),
    "Forces": ("torchmd_tpu_torch.forces", "Forces"),
    "Integrator": ("torchmd_tpu_torch.integrator", "Integrator"),
    "maxwell_boltzmann": ("torchmd_tpu_torch.integrator", "maxwell_boltzmann"),
    "ffparams_from_numpy": ("torchmd_tpu_torch.interop", "ffparams_from_numpy"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'torchmd_tpu_torch' has no attribute {name!r}")
