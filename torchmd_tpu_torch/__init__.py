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

From the command line (the reference CLI: YAML `--conf`, force terms,
Langevin or Nose-Hoover, replicas, minimisation, an external NNP config,
checkpoints; `--device cpu` for the CPU):

    python -m torchmd_tpu_torch.run --conf tests/systems/argon/conf.yaml

NPT (MTK barostat, 1 bar, on the column kernel on the card):

    integ = Integrator(system, forces, 2.0, T=300, thermostat="nhc",
                       constraints="settle",
                       barostat=MTKBarostat(1.0, 300.0, tau_fs=2000.0))

The production protocol (a protein at 4 fs: X-H bonds by SHAKE/RATTLE,
hydrogen masses x3 on the System, CSVR; a Monte Carlo barostat between
chunks; Calpha atoms restrained through the external slot):

    from torchmd_tpu_torch import (HarmonicPositionalRestraint,
                                   MonteCarloBarostat, Wrapper,
                                   repartition_hydrogen_masses)

    system.set_masses(repartition_hydrogen_masses(par.masses, mol.bonds, 3.0))
    ca = np.flatnonzero(mol.name == "CA")
    forces = Forces(par, terms=terms, cutoff=9.0, elec="ewald",
                    external=HarmonicPositionalRestraint(coords[ca], 1.0, ca))
    integ = Integrator(system, forces, 4.0, T=300, thermostat="csvr",
                       constraints="hbonds")
    baro = MonteCarloBarostat(1.0, 300.0, group_id=Wrapper(
        mol.numAtoms, mol.bonds).group_id)
    for _ in range(100):
        integ.step(niter=25)
        baro.attempt(system, forces)

or `python -m torchmd_tpu_torch.run ... --timestep 4 --constraints hbonds
--hmr 3 --thermostat csvr --pressure 1`.

r-RESPA (bonded terms on 4 substeps of each 2 fs step; on the neighbour
paths with Ewald/PME, the reciprocal term every 2 steps), Verlet lists,
and MTK on a small box with SHAKE on the exact Ewald sum:

    integ = Integrator(system, forces, 2.0, T=300, thermostat="nhc",
                       mts=4, mts_recip=2)          # or --mts 4 --mts-recip 2
    forces = Forces(par, terms=terms, cutoff=9.0, kernel="verlet")
    forces = Forces(par, terms=terms, cutoff=9.0, elec="ewald")  # < 4,096 atoms
    integ = Integrator(system, forces, 4.0, T=300, thermostat="nhc",
                       constraints="hbonds", barostat=MTKBarostat(1.0, 300.0))

Implicit solvent and enhanced sampling (a protein from a prmtop with
RADII and SCREEN; `--gbsa` on the CLI): GB/OBC as the external, a
temperature ladder whose every force evaluation launches the pair and
bonded kernels once for all replicas, metadynamics on a CV, alchemical
decoupling of a ligand and lambda-dynamics:

    from torchmd_tpu_torch import (GBSA, MetaDynamics, ReplicaExchange,
                                   LambdaDynamics, make_alchemical,
                                   make_gbsa, make_lambda_sites)
    from torchmd_tpu_torch.cv import com_distance_cv

    forces = Forces(par, terms=terms, cutoff=9.0, rfa=True,
                    external=make_gbsa(par, mol))
    remd = ReplicaExchange(system8, forces, 2.0, np.geomspace(300, 400, 8))
    remd.run(1000, exchange_period=100)
    metad = MetaDynamics(system, forces, com_distance_cv(ligand, pocket),
                         2.0, T=300, grid=(0.0, 20.0, 400), sigma=0.2,
                         height=0.3, stride=50, bias_factor=10.0)
    coupling = make_alchemical(forces, ligand, lam=0.5)

The AMOEBA polarizable force field from TINKER .prm text and an .xyz
frame (multipole PME, Thole mutual polarization, 14-7 vdW, valence; its
evaluation one CUDA graph on the card), as the only term of `Forces`:

    from torchmd_tpu_torch.amoeba import (make_amoeba_potential,
                                          parse_tinker_prm, read_tinker_xyz)

    coords, types, bonds, box = read_tinker_xyz("box.xyz")
    pot, _ = make_amoeba_potential(ffparams, types, bonds,
                                   parse_tinker_prm(prm_text), cutoff=9.0,
                                   switch_dist=8.1, ewald=True, box=box,
                                   valence=True)   # ffparams: its nb_mask
    forces = Forces(par, terms=[], external=pot)

Drude oscillators (polarizabilities per atom, or from a force field's
`polarizabilities:` section): the extended system runs the pair and
bonded kernels on the card, an SCF solve relaxes the Drudes, and the
dual-Langevin integrator keeps them cold:

    from torchmd_tpu_torch import DrudeIntegrator, make_drude
    from torchmd_tpu_torch.drude import init_drude_positions, scf_drude

    ffp_ext, spec = make_drude(forces, alpha=alpha)
    pos = scf_drude(ffp_ext, spec, forces.config,
                    init_drude_positions(coords, spec), None)
    integ = DrudeIntegrator(ffp_ext, spec, forces.config, pos, T=300.0,
                            T_drude=1.0, dtype=torch.float32)
    Ekin, Epot, T, T_rel = integ.step(niter=100)

A neural-network potential (`nnp.train_nnp`, then `nnp.NNPExternal` as
`Forces(external=...)`), force matching of force-field parameters
(`train.ForceMatchingTrainer`) and a PNG of a frame (`view_frame`).
"""

__version__ = "0.1.0"

__all__ = [
    "systems", "potentials", "bonded", "forces", "integrator", "interop",
    "ops", "io", "forcefields", "parameters", "units", "neighbors", "ewald",
    "vsites", "constraints", "thermostats", "columns", "barostat",
    "cmap", "restraints", "gb", "cv", "metadynamics", "remd", "alchemy",
    "lambda_dynamics", "analysis", "multipoles", "multipole_ewald",
    "amoeba_valence", "amoeba", "drude", "nnp", "train", "viz",
    "external", "run", "utils", "wrapper", "checkpoint", "observables",
    "minimizers", "profiling", "native", "neighbourlist", "npzmol", "mycalc",
    "calculators", "parallel",
    # convenience re-exports (lazy)
    "Molecule", "ForceField", "AmberForcefield", "GromacsForcefield",
    "YamlForcefield", "CharmmForcefield", "npzMolecule",
    "Parameters", "System", "Forces", "Integrator", "maxwell_boltzmann",
    "ffparams_from_numpy", "MTKBarostat", "TorchExternal", "External",
    "Wrapper", "LogWriter", "save_checkpoint", "load_checkpoint", "pressure",
    "minimize_bfgs", "minimize_lbfgs", "minimize_fire", "minimize_cg",
    "StepTimer", "MyCalc", "MonteCarloBarostat", "MonteCarloAnisotropicBarostat",
    "MonteCarloMembraneBarostat", "repartition_hydrogen_masses",
    "HarmonicPositionalRestraint", "FlatBottomRestraint",
    "AnisotropicPositionalRestraint", "combine_externals",
    "EwaldRecip", "PmeRecip", "VerletKernel", "VerletConfig", "CellKernel",
    "make_alchemical", "AlchemicalCoupling", "ReplicaExchange", "MetaDynamics",
    "HarmonicBias", "wham", "LambdaDynamics", "make_lambda_sites", "ph_bias",
    "normal_modes", "GBSA", "make_gbsa", "apply_vsites", "make_multipoles",
    "MultipoleEwald", "MultipolePme", "make_amoeba_potential", "make_drude",
    "DrudeIntegrator", "make_drude_ewald", "view_frame",
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
    "YamlForcefield": ("torchmd_tpu_torch.forcefields.ff_yaml", "YamlForcefield"),
    "CharmmForcefield": ("torchmd_tpu_torch.forcefields.ff_charmm", "CharmmForcefield"),
    "npzMolecule": ("torchmd_tpu_torch.io", "npzMolecule"),
    "TorchExternal": ("torchmd_tpu_torch.external", "TorchExternal"),
    "External": ("torchmd_tpu_torch.external", "External"),
    "Wrapper": ("torchmd_tpu_torch.wrapper", "Wrapper"),
    "LogWriter": ("torchmd_tpu_torch.utils", "LogWriter"),
    "save_checkpoint": ("torchmd_tpu_torch.checkpoint", "save_checkpoint"),
    "load_checkpoint": ("torchmd_tpu_torch.checkpoint", "load_checkpoint"),
    "pressure": ("torchmd_tpu_torch.observables", "pressure"),
    "minimize_bfgs": ("torchmd_tpu_torch.minimizers", "minimize_bfgs"),
    "minimize_lbfgs": ("torchmd_tpu_torch.minimizers", "minimize_lbfgs"),
    "minimize_fire": ("torchmd_tpu_torch.minimizers", "minimize_fire"),
    "minimize_cg": ("torchmd_tpu_torch.minimizers", "minimize_cg"),
    "StepTimer": ("torchmd_tpu_torch.profiling", "StepTimer"),
    "MyCalc": ("torchmd_tpu_torch.mycalc", "MyCalc"),
    "MonteCarloBarostat": ("torchmd_tpu_torch.barostat", "MonteCarloBarostat"),
    "MonteCarloAnisotropicBarostat": ("torchmd_tpu_torch.barostat",
                                      "MonteCarloAnisotropicBarostat"),
    "MonteCarloMembraneBarostat": ("torchmd_tpu_torch.barostat",
                                   "MonteCarloMembraneBarostat"),
    "repartition_hydrogen_masses": ("torchmd_tpu_torch.constraints",
                                    "repartition_hydrogen_masses"),
    "HarmonicPositionalRestraint": ("torchmd_tpu_torch.restraints",
                                    "HarmonicPositionalRestraint"),
    "FlatBottomRestraint": ("torchmd_tpu_torch.restraints", "FlatBottomRestraint"),
    "AnisotropicPositionalRestraint": ("torchmd_tpu_torch.restraints",
                                       "AnisotropicPositionalRestraint"),
    "combine_externals": ("torchmd_tpu_torch.external", "combine_externals"),
    "EwaldRecip": ("torchmd_tpu_torch.ewald", "EwaldRecip"),
    "PmeRecip": ("torchmd_tpu_torch.ewald", "PmeRecip"),
    "VerletKernel": ("torchmd_tpu_torch.neighbors", "VerletKernel"),
    "VerletConfig": ("torchmd_tpu_torch.neighbors", "VerletConfig"),
    "CellKernel": ("torchmd_tpu_torch.neighbors", "CellKernel"),
    "make_alchemical": ("torchmd_tpu_torch.alchemy", "make_alchemical"),
    "AlchemicalCoupling": ("torchmd_tpu_torch.alchemy", "AlchemicalCoupling"),
    "ReplicaExchange": ("torchmd_tpu_torch.remd", "ReplicaExchange"),
    "MetaDynamics": ("torchmd_tpu_torch.metadynamics", "MetaDynamics"),
    "HarmonicBias": ("torchmd_tpu_torch.cv", "HarmonicBias"),
    "wham": ("torchmd_tpu_torch.cv", "wham"),
    "LambdaDynamics": ("torchmd_tpu_torch.lambda_dynamics", "LambdaDynamics"),
    "make_lambda_sites": ("torchmd_tpu_torch.lambda_dynamics", "make_lambda_sites"),
    "ph_bias": ("torchmd_tpu_torch.lambda_dynamics", "ph_bias"),
    "normal_modes": ("torchmd_tpu_torch.analysis", "normal_modes"),
    "GBSA": ("torchmd_tpu_torch.gb", "GBSA"),
    "make_gbsa": ("torchmd_tpu_torch.gb", "make_gbsa"),
    "apply_vsites": ("torchmd_tpu_torch.vsites", "apply_vsites"),
    "make_multipoles": ("torchmd_tpu_torch.multipoles", "make_multipoles"),
    "MultipoleEwald": ("torchmd_tpu_torch.multipole_ewald", "MultipoleEwald"),
    "MultipolePme": ("torchmd_tpu_torch.multipole_ewald", "MultipolePme"),
    "make_amoeba_potential": ("torchmd_tpu_torch.amoeba", "make_amoeba_potential"),
    "make_drude": ("torchmd_tpu_torch.drude", "make_drude"),
    "DrudeIntegrator": ("torchmd_tpu_torch.drude", "DrudeIntegrator"),
    "make_drude_ewald": ("torchmd_tpu_torch.drude", "make_drude_ewald"),
    "view_frame": ("torchmd_tpu_torch.viz", "view_frame"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'torchmd_tpu_torch' has no attribute {name!r}")
