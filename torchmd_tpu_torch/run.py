"""Command-line simulation runner (the port's counterpart of
`torchmd_tpu.run`): `python -m torchmd_tpu_torch.run`.

The reference CLI surface (torchmd/run.py:30-297) with the JAX package's
flags and defaults: YAML `--conf` merging (or a GROMACS `.mdp`), force
terms, cutoff/switching/RFA, Langevin or Nose-Hoover thermostat,
replicas, minimization, an external (NNP) config, npz input; the same
outputs (per-replica monitor_{k}.csv, {output}_{k}.npy or .dcd
trajectory, final .xyz), `--checkpoint-period` / `--resume`, and
`--profile` (a torch.profiler Chrome trace in the log directory).

The production protocol: `--constraints hbonds|allbonds|settle`
(SHAKE/RATTLE, SETTLE), `--hmr` (hydrogen mass repartitioning: the
System gets the repartitioned masses, the parameters keep the force
field's, which say what the hydrogens are), `--thermostat nhc|csvr`,
`--pressure` with `--barostat-mode iso|aniso|membrane` (a Monte Carlo
move after each output period) or `mtk*` (MTK dynamics), and an `.mdp`
`define` (e.g. -DPOSRES: the topology's position, distance and dihedral
restraints join the run as external potentials, referenced to the
starting coordinates, summed with an `--external` one). `--mts N` runs
r-RESPA (N bonded substeps per timestep) and `--mts-recip R` its
reciprocal tier (the Ewald/PME term every R outer steps on the
neighbour-list paths, with `--output-period` a multiple of R). `--gbsa`
adds GB/OBC implicit solvent with the ACE surface term (`gb.make_gbsa`:
the prmtop's RADII and SCREEN, else element radii), summed with the
topology's restraints and an `--external` one.

`--device`: None or `cuda[:k]` run on the CUDA card, `cpu` on the CPU;
anything else raises ValueError. Without a card and without `--device
cpu` the run raises, as the port's entry points do.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import os
import time

import numpy as np

from .units import FS2NS
from .utils import (
    AsyncWriter,
    LoadFromFile,
    LogWriter,
    save_argparse,
    xyz_writer,
)


def get_args(arguments=None):
    parser = argparse.ArgumentParser(description="TorchMD-TPU (PyTorch + CUDA port)",
                                     prefix_chars="--")
    parser.add_argument("--conf", type=open, action=LoadFromFile,
                        help="Configuration yaml file")
    parser.add_argument("--timestep", default=1, type=float, help="Timestep in fs")
    parser.add_argument("--temperature", default=300, type=float,
                        help="Assign velocity from initial temperature in K")
    parser.add_argument("--langevin-temperature", default=0, type=float,
                        help="Temperature in K of the thermostat")
    parser.add_argument("--langevin-gamma", default=0.1, type=float,
                        help="Langevin relaxation ps^-1")
    parser.add_argument("--thermostat", default="langevin",
                        choices=["langevin", "nhc", "csvr"],
                        help="NVT thermostat: langevin (reference numerics), "
                             "nhc (Nose-Hoover chain), csvr (Bussi rescale); "
                             "nhc/csvr use --langevin-temperature as target")
    parser.add_argument("--thermostat-tau", default=None, type=float,
                        help="NHC/CSVR time constant in fs "
                             "(default 100 * timestep)")
    parser.add_argument("--solvent-dielectric", default=78.5, type=float,
                        help="Reaction-field solvent dielectric (with --rfa)")
    parser.add_argument("--mts", default=None, type=int,
                        help="r-RESPA multiple timestepping: number of "
                             "inner bonded substeps per (outer) timestep")
    parser.add_argument("--mts-recip", default=None, type=int,
                        help="three-tier r-RESPA: evaluate the Ewald/PME "
                             "reciprocal term every N outer steps "
                             "(neighbor-kernel path with elec=ewald; "
                             "output-period must divide by N)")
    parser.add_argument("--gbsa", action="store_true", default=False,
                        help="GB/OBC implicit solvent with the ACE surface term")
    parser.add_argument("--device", default=None,
                        help="Device: cuda[:k] | cpu | None (the CUDA card)")
    parser.add_argument("--structure", default=None, help="Deprecated: Input PDB")
    parser.add_argument("--topology", default=None, help="Input topology")
    parser.add_argument("--coordinates", default=None, help="Input coordinates")
    parser.add_argument("--forcefield", default=None, help="Force field file(s)")
    parser.add_argument("--seed", type=int, default=1, help="random seed")
    parser.add_argument("--output-period", type=int, default=10,
                        help="Store trajectory and print monitor.csv every period")
    parser.add_argument("--save-period", type=int, default=0,
                        help="Dump trajectory to npy; default 10x output-period")
    parser.add_argument("--async-output", type=int, default=1,
                        help="Stream trajectory/monitor writes from a "
                             "background thread, overlapping IO with the "
                             "next chunk of steps (0 = synchronous)")
    parser.add_argument("--checkpoint-period", type=int, default=0,
                        help="Write a restart checkpoint every N steps (0=off)")
    parser.add_argument("--resume", default=None,
                        help="Resume from checkpoint file")
    parser.add_argument("--steps", type=int, default=10000,
                        help="Total number of simulation steps")
    parser.add_argument("--log-dir", default="./", help="Log directory")
    parser.add_argument("--output", default="output", help="Output filename")
    parser.add_argument("--forceterms", nargs="+", default="LJ",
                        help="Forceterms to include, e.g. --forceterms Bonds LJ")
    parser.add_argument("--cutoff", default=None, type=float,
                        help="LJ/Elec/Bond cutoff")
    parser.add_argument("--switch_dist", default=None, type=float,
                        help="Switching distance for LJ")
    parser.add_argument("--precision", default="single", type=str,
                        help="single | double")
    parser.add_argument("--external", default=None, type=dict,
                        help="External calculator config")
    parser.add_argument("--rfa", default=False, action="store_true",
                        help="Enable reaction field approximation")
    parser.add_argument("--replicas", type=int, default=1,
                        help="Number of different replicas to run")
    parser.add_argument("--extended_system", default=None,
                        help="xsc file for box size")
    parser.add_argument("--minimize", default=None, type=int,
                        help="Minimize the system for `minimize` steps")
    parser.add_argument("--minimize-method", default="bfgs", type=str,
                        help="Minimizer: bfgs (scipy L-BFGS-B) | fire "
                             "(on the device) | lbfgs (on the device, torch.optim)")
    parser.add_argument("--exclusions", default=("bonds", "angles", "1-4"),
                        type=tuple, help="exclusions for the LJ/repulsionCG term")
    parser.add_argument("--npz_file", default=None, type=str,
                        help="Input file.npz with coord and z")
    parser.add_argument("--constraints", default=None, type=str,
                        help="Bond constraints: hbonds | allbonds (SHAKE/"
                             "RATTLE) | settle (analytic rigid waters + "
                             "SHAKE on other H bonds)")
    parser.add_argument("--hmr", default=None, type=float,
                        help="Hydrogen mass repartitioning factor (e.g. 3.0;"
                             " combine with --constraints for 4 fs steps)")
    parser.add_argument("--pressure", default=None, type=float,
                        help="NPT target pressure in bar (MC barostat)")
    parser.add_argument("--barostat-mode", default="iso",
                        choices=["iso", "aniso", "membrane", "mtk",
                                 "mtk-aniso", "mtk-membrane"],
                        help="NPT barostat: iso/aniso/membrane MC volume "
                             "moves, or mtk[-aniso|-membrane] (Martyna-"
                             "Tobias-Klein extended-system dynamics; uses "
                             "--thermostat nhc|csvr and, for mtk-membrane, "
                             "--surface-tension)")
    parser.add_argument("--surface-tension", default=0.0, type=float,
                        help="Membrane barostat surface tension in "
                             "bar*Angstrom (1 bar*A = 10 mN/m)")
    parser.add_argument("--elec", default="auto", type=str,
                        help="Electrostatics: auto (Coulomb/RFA) | ewald | pme")
    parser.add_argument("--nbfix", default=False, action="store_true",
                        help="Apply CHARMM NBFIX pair-specific LJ overrides")
    parser.add_argument("--profile", default=False, action="store_true",
                        help="Capture a torch.profiler trace of the hot loop")
    parser.add_argument("--traj-format", default="npy", type=str,
                        help="Trajectory format: npy (reference behavior) | dcd")

    args = parser.parse_args(args=arguments)
    os.makedirs(args.log_dir, exist_ok=True)
    save_argparse(args, os.path.join(args.log_dir, "input.yaml"), exclude="conf")

    if isinstance(args.forceterms, str):
        args.forceterms = [args.forceterms]
    if args.steps % args.output_period != 0:
        raise ValueError("Steps must be multiple of output-period.")
    if args.save_period == 0:
        args.save_period = 10 * args.output_period
    if args.save_period % args.output_period != 0:
        raise ValueError("save-period must be multiple of output-period.")
    return args


def resolve_cli_device(device):
    """`--device` -> torch.device: None or cuda[:k] the card (raising
    without one), cpu the CPU; anything else raises ValueError."""
    import torch

    name = None if device is None else str(device)
    if name is None or name == "cuda" or name.startswith("cuda:"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"--device {name}: no CUDA device; the port runs on the card "
                "unless asked otherwise: pass --device cpu to run on the CPU")
        return torch.device(name or "cuda")
    if name == "cpu":
        return torch.device("cpu")
    raise ValueError(f"--device {name!r}: the port runs on cuda[:k] or cpu")


def gmx_defines(args):
    """An .mdp's `define = -DNAME[=value] ...` as the GROMACS reader's
    defines (NAME -> value or None); the JAX CLI's TMD_GMX_DEFINES scope
    (torchmd_tpu/run.py:215-238), given to the readers directly, since
    the port reads no environment."""
    out = {}
    for tok in getattr(args, "gmx_defines", None) or ():
        name, _, val = str(tok).partition("=")
        out[name] = val if val else None
    return out


def _load_molecule(args):
    """Build the Molecule from whichever input flag was given, folding in
    coordinate/box files. Returns (mol, is_npz)."""
    from .io import Molecule, npzMolecule

    if args.npz_file is not None:
        return npzMolecule(args.npz_file), True

    topo = args.topology if args.topology is not None else args.structure
    if topo is None:
        raise RuntimeError("Provide --topology, --structure or --npz_file")
    mol = Molecule(topo, defines=gmx_defines(args))
    if args.topology is None and mol.crystalinfo is not None:
        # PDB CRYST1 record carries the box when no topology file is given.
        abc = [mol.crystalinfo[k] for k in ("a", "b", "c")]
        mol.box = np.asarray(abc, dtype=np.float64).reshape(3, 1)
    for extra in (args.coordinates, args.extended_system):
        if extra is not None:
            mol.read(extra)
    return mol, False


def _instantiate_external(args, mol, is_npz, device):
    """Construct the external (NNP) calculator described by the --external
    dict: import `module`, tile per-atom embeddings across replicas, and
    pass the remaining keys through as constructor kwargs."""
    spec = args.external
    if spec is None:
        return None
    spec = dict(spec)
    module_name = spec.pop("module")
    weights = spec.pop("file", None)
    emb = spec.pop("embeddings", None)
    if is_npz:
        per_atom = np.asarray(mol.embedding)
    elif isinstance(emb, str):
        per_atom = np.load(emb).astype(int)
    else:
        per_atom = np.asarray(emb)
    per_atom = per_atom.reshape(-1)
    embeddings = np.repeat(per_atom[None], args.replicas, axis=0)
    factory = getattr(importlib.import_module(module_name), "External")
    return factory(weights, embeddings, device=str(device), **spec)


def setup(args, batch_comp=False):
    from .forcefields import ForceField
    from .forces import Forces
    from .integrator import maxwell_boltzmann
    from .parameters import Parameters
    from .systems import System

    device = resolve_cli_device(args.device)
    mol, is_npz = _load_molecule(args)
    batch_comp = batch_comp or is_npz

    print("Force terms: ", args.forceterms)
    ff = ForceField.create(mol, args.forcefield, defines=gmx_defines(args))
    parameters = Parameters(ff, mol, args.forceterms, precision=args.precision,
                            device=str(device))
    masses = np.asarray(parameters.masses, np.float64)
    if getattr(args, "hmr", None):
        from .constraints import repartition_hydrogen_masses

        # the System carries the dynamical masses; the parameters keep the
        # force field's, from which the constraints pick the hydrogens
        masses = repartition_hydrogen_masses(
            masses, mol.bonds, factor=args.hmr).reshape(masses.shape)

    system = System(mol.numAtoms, args.replicas, args.precision, str(device))
    system.set_positions(mol.coords)
    system.set_box(mol.box)
    system.set_masses(masses)
    file_vel = getattr(mol, "velocities", None)
    if getattr(args, "use_file_velocities", False) and file_vel is not None:
        # continuation: .gro velocities are A/ps; internal velocities are
        # A per AKMA time unit (TIMEFACTOR fs)
        from .units import TIMEFACTOR

        v = np.asarray(file_vel, dtype=np.float64) * (TIMEFACTOR / 1000.0)
        vel0 = np.repeat(v[None], args.replicas, axis=0)
    else:
        vel0 = maxwell_boltzmann(masses, args.temperature, args.replicas,
                                 seed=args.seed, device=device)
    system.set_velocities(vel0)

    external = _instantiate_external(args, mol, batch_comp, device)
    restraints = []
    if getattr(parameters, "gmx_posres", None) is not None:
        # GROMACS restraints (present when their #ifdef, typically POSRES,
        # was defined): referenced to the starting coordinates (GROMACS's
        # -r default); disre-fc comes through the .mdp translation
        from .restraints import (make_gromacs_dihres, make_gromacs_distres,
                                 make_gromacs_posres)

        restraints = [r for r in (
            make_gromacs_posres(parameters, mol.coords[:, :, 0]),
            make_gromacs_distres(parameters, fc_kj_nm2=getattr(args, "disre_fc", 1000.0)),
            make_gromacs_dihres(parameters),
        ) if r is not None]
    if getattr(args, "gbsa", False):
        from .gb import make_gbsa

        restraints.append(make_gbsa(
            parameters, mol, solvent_dielectric=getattr(args, "solvent_dielectric", 78.5),
            cutoff=args.cutoff, device=device))
    if restraints:
        from .external import combine_externals

        external = combine_externals(
            restraints + ([external] if external is not None else []))
    forces = Forces(
        parameters,
        terms=args.forceterms,
        external=external,
        cutoff=args.cutoff,
        rfa=args.rfa,
        solventDielectric=getattr(args, "solvent_dielectric", 78.5),
        switch_dist=args.switch_dist,
        exclusions=args.exclusions,
        precision=args.precision,
        elec=getattr(args, "elec", "auto"),
        nbfix=getattr(args, "nbfix", False),
        device=device,
    )
    return mol, system, forces


class _Progress:
    """Progress lines on stdout at every tenth of the run (the JAX CLI's
    tqdm bar; tqdm is not a dependency of the port)."""

    def __init__(self, start, stop, period):
        self.start, self.stop, self.period = start, stop, period
        self.every = max(1, (stop - start + 1) // 10)
        self.t0 = time.perf_counter()

    def update(self, i):
        if (i - self.start + 1) % self.every and i != self.stop:
            return
        done = (i - self.start + 1) * self.period
        rate = done / max(time.perf_counter() - self.t0, 1e-9)
        print(f"step {i * self.period}/{self.stop * self.period} "
              f"({rate:.1f} steps/s)", flush=True)


def dynamics(args, mol, system, forces):
    """The run loop; returns a `profiling.StepTimer` summary of it
    (steps, elapsed_s, steps_per_sec, ns_per_day)."""
    from .checkpoint import load_checkpoint, save_checkpoint
    from .integrator import Integrator
    from .minimizers import minimize_bfgs
    from .profiling import StepTimer, trace
    from .wrapper import Wrapper

    mode = getattr(args, "barostat_mode", "iso") or "iso"
    mtk = None
    thermo_name = getattr(args, "thermostat", "langevin")
    if getattr(args, "pressure", None) is not None and mode.startswith("mtk"):
        from .barostat import MTKBarostat

        T_b = args.langevin_temperature or args.temperature
        mtk = MTKBarostat(
            args.pressure, T_b,
            mode={"mtk": "iso", "mtk-aniso": "aniso",
                  "mtk-membrane": "membrane"}[mode],
            surface_tension=getattr(args, "surface_tension", 0.0) or 0.0,
        )
        if (thermo_name or "langevin").lower() in ("langevin", "none"):
            # MTK needs a deterministic/global thermostat (no Langevin
            # piston); NHC is the canonical companion
            print("MTK barostat: using NHC thermostat "
                  "(Langevin piston is not implemented)")
            thermo_name = "nhc"

    integrator = Integrator(
        system, forces, args.timestep,
        gamma=args.langevin_gamma,
        T=args.langevin_temperature or (mtk.T if mtk is not None else None),
        seed=args.seed,
        constraints=getattr(args, "constraints", None),
        thermostat=thermo_name,
        tau=getattr(args, "thermostat_tau", None),
        barostat=mtk,
        mts=getattr(args, "mts", None),
        mts_recip=getattr(args, "mts_recip", None),
    )
    wrapper = Wrapper(mol.numAtoms, mol.bonds if len(mol.bonds) else None)

    barostat = None
    if getattr(args, "pressure", None) is not None and mtk is None:
        from .barostat import (MonteCarloAnisotropicBarostat, MonteCarloBarostat,
                               MonteCarloMembraneBarostat)

        T_b = args.langevin_temperature or args.temperature
        if mode == "aniso":
            barostat = MonteCarloAnisotropicBarostat(
                args.pressure, T_b, group_id=wrapper.group_id, seed=args.seed)
        elif mode == "membrane":
            barostat = MonteCarloMembraneBarostat(
                args.pressure, T_b,
                surface_tension=getattr(args, "surface_tension", 0.0) or 0.0,
                group_id=wrapper.group_id, seed=args.seed)
        else:
            barostat = MonteCarloBarostat(
                args.pressure, T_b, group_id=wrapper.group_id, seed=args.seed)

    outputname, outputext = os.path.splitext(args.output)
    use_dcd = getattr(args, "traj_format", "npy") == "dcd"
    dcd_writers = []
    if use_dcd:
        from .io.dcd import DCDWriter

        dcd_writers = [
            DCDWriter(
                os.path.join(args.log_dir, f"{outputname}_{k}.dcd"),
                mol.numAtoms, timestep_fs=args.timestep,
                save_period=args.output_period,
            )
            for k in range(args.replicas)
        ]
    start_iter = 1
    trajs = [[] for _ in range(args.replicas)]
    if args.resume:
        start_iter = load_checkpoint(args.resume, system, integrator) + 1
        # Preserve pre-crash outputs: reload already-saved trajectory frames
        # so the next np.save extends rather than truncates them.
        if not use_dcd:
            for k in range(args.replicas):
                prior = os.path.join(args.log_dir,
                                     f"{outputname}_{k}{outputext or '.npy'}")
                if os.path.exists(prior):
                    old = np.load(prior)  # (natoms, 3, nframes)
                    trajs[k] = [old[:, :, j] for j in range(old.shape[2])]
    logs = [
        LogWriter(
            args.log_dir,
            keys=("iter", "ns", "epot", "ekin", "etot", "T"),
            name=f"monitor_{k}.csv",
            append=bool(args.resume),
        )
        for k in range(args.replicas)
    ]

    if args.minimize is not None:
        method = getattr(args, "minimize_method", "bfgs")
        if method == "fire":
            from .minimizers import minimize_fire

            minimize_fire(system, forces, steps=args.minimize)
        elif method == "lbfgs":
            from .minimizers import minimize_lbfgs

            minimize_lbfgs(system, forces, steps=max(1, args.minimize // 20),
                           verbose=False)
        else:
            minimize_bfgs(system, forces, steps=args.minimize)

    if not args.resume or args.minimize is not None:
        # a resumed run keeps the checkpoint's forces: under r-RESPA they
        # are the carried slow forces, which a fresh evaluation (the
        # total, as the JAX CLI takes) would replace with a dt/2 F_bonded
        # kick at the first step
        forces.compute(system.pos, system.box, system.forces)

    def emit(i, currpos, boxsnap, epot_arr, ekin_arr, t_arr):
        """All per-output-period file writes for one iteration; runs on
        the background writer thread (only it touches trajs/logs/dcd
        after the loop starts), overlapping IO with the next chunk."""
        for k in range(args.replicas):
            if use_dcd:
                dcd_writers[k].write_frame(currpos[k], np.diag(boxsnap[k]))
            else:
                trajs[k].append(currpos[k])
                if (i * args.output_period) % args.save_period == 0:
                    np.save(
                        os.path.join(args.log_dir, f"{outputname}_{k}{outputext}"),
                        np.stack(trajs[k], axis=2),
                    )
            logs[k].write_row(
                {
                    "iter": i * args.output_period,
                    "ns": FS2NS * i * args.output_period * args.timestep,
                    "epot": float(epot_arr[k]),
                    "ekin": float(ekin_arr[k]),
                    "etot": float(epot_arr[k] + ekin_arr[k]),
                    "T": float(t_arr[k]),
                }
            )

    stop = int(args.steps / args.output_period)
    timer = StepTimer(args.timestep, device=forces.device)
    progress = _Progress(start_iter, stop, args.output_period)
    writer = AsyncWriter() if getattr(args, "async_output", 1) else None
    profile_ctx = (trace(os.path.join(args.log_dir, "torch_trace")) if args.profile
                   else contextlib.nullcontext())
    try:
        with profile_ctx, timer.measure(max(0, stop - start_iter + 1) * args.output_period):
            for i in range(start_iter, stop + 1):
                Ekin, Epot, T = integrator.step(niter=args.output_period)
                if barostat is not None:
                    barostat.attempt(system, forces)
                wrapper.wrap(system.pos, system.box)
                payload = (
                    i, system.pos.copy(), system.box.copy(),
                    np.asarray(Epot, dtype=np.float64).reshape(-1).copy(),
                    np.asarray(Ekin, dtype=np.float64).reshape(-1).copy(),
                    np.asarray(T, dtype=np.float64).reshape(-1).copy(),
                )
                if writer is not None:
                    writer.submit(lambda p=payload: emit(*p))
                else:
                    emit(*payload)
                if args.checkpoint_period and (
                    (i * args.output_period) % args.checkpoint_period == 0
                ):
                    # checkpoints read live System state: keep them synchronous
                    save_checkpoint(
                        os.path.join(args.log_dir, f"{outputname}.chk"),
                        system, integrator, i,
                    )
                progress.update(i)
    finally:
        if writer is not None:
            writer.close()
        for log in logs:
            log.close()

    for w in dcd_writers:
        w.close()
    for k in range(args.replicas):
        npy_name = os.path.join(args.log_dir, args.output + f"_{k}.npy")
        xyz_name = os.path.join(args.log_dir, args.output + f"_{k}.xyz")
        if os.path.exists(npy_name):
            xyz_writer(npy_name, xyz_name, mol.element)
    return timer.summary()


def main(arguments=None):
    args = get_args(arguments)
    mol, system, forces = setup(args)
    return dynamics(args, mol, system, forces)


if __name__ == "__main__":
    main()
