"""Rank functions of the port's mesh tests (`test_torch_parallel.py`,
`test_torch_spatial.py`, `test_torch_halo.py`), run on the ranks of a `parallel.launch.Ranks`
pool. The ranks import this module to unpickle the functions, so it
imports neither JAX nor the JAX package: systems are built with the
port's own front end, and every result goes back as numpy.

Each function takes (rank, spec) and builds the same System, Forces and
Integrator on every rank, as a user of the mesh would."""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from torchmd_tpu_torch.forcefields import ForceField
from torchmd_tpu_torch.forces import Forces
from torchmd_tpu_torch.integrator import Integrator
from torchmd_tpu_torch.io import Molecule
from torchmd_tpu_torch.parallel import make_mesh, shard_replicas, sharded_energy_fn
from torchmd_tpu_torch.parameters import Parameters
from torchmd_tpu_torch.systems import System

HERE = os.path.dirname(os.path.abspath(__file__))
DATA_DIR = os.path.join(HERE, "data")
SYSTEMS_DIR = os.path.join(HERE, "systems")
ALL_TERMS = ["bonds", "angles", "dihedrals", "impropers", "1-4", "electrostatics", "lj"]
ALANINE_NB = dict(cutoff=9.0, switch_dist=7.5, rfa=True)
ARGON_L = 77.395


# ----------------------------------------------------------------------
# Systems (the port's front end; the tests build the same ones with the
# JAX package's)
# ----------------------------------------------------------------------

def alanine(terms=ALL_TERMS):
    d = os.path.join(DATA_DIR, "prod_alanine_dipeptide_amber")
    mol = Molecule(os.path.join(d, "structure.prmtop"))
    mol.read(os.path.join(d, "input.coor"))
    mol.read(os.path.join(d, "input.xsc"))
    ff = ForceField.create(mol, os.path.join(d, "structure.prmtop"))
    return mol, Parameters(ff, mol, terms, precision="double")


def argon(charges_seed=None, terms=("lj",)):
    d = os.path.join(SYSTEMS_DIR, "argon")
    mol = Molecule(os.path.join(d, "argon_start.pdb"))
    if charges_seed is not None:
        mol.charge = np.random.RandomState(charges_seed).randn(mol.numAtoms) * 0.05
    ff = ForceField.create(mol, os.path.join(d, "argon_forcefield.yaml"))
    par = Parameters(ff, mol, list(terms), precision="double")
    if charges_seed is not None:
        par.charges = mol.charge.copy()
    return mol, par


def water():
    d = os.path.join(SYSTEMS_DIR, "water")
    mol = Molecule(os.path.join(d, "structure.psf"))
    mol.read(os.path.join(d, "structure.pdb"))
    ff = ForceField.create(mol, os.path.join(d, "water_forcefield.yaml"))
    terms = ["bonds", "angles", "lj", "electrostatics"]
    return mol, Parameters(ff, mol, terms, precision="double"), terms


def tip4p(top_text, coords, L):
    """TIP4P/2005 waters from a GROMACS topology text and (N, 3) coords."""
    with tempfile.TemporaryDirectory() as td:
        top = os.path.join(td, "tip4p.top")
        with open(top, "w") as fh:
            fh.write(top_text)
        mol = Molecule(top)
        ff = ForceField.create(mol, top)
    mol.coords = np.asarray(coords, np.float64)[:, :, None]
    mol.box = np.full((3, 1), L)
    terms = ["bonds", "lj", "electrostatics"]
    return mol, Parameters(ff, mol, terms, precision="double"), terms


def system_of(spec):
    """(mol, par, Forces kwargs) of a spec's system."""
    name = spec["system"]
    if name == "alanine":
        mol, par = alanine()
        return mol, par, dict(terms=ALL_TERMS, **ALANINE_NB)
    if name == "argon-cell":
        mol, par = argon(0, ("lj", "electrostatics"))
        mol.box = np.full((3, 1), ARGON_L)
        return mol, par, dict(terms=["lj", "electrostatics"], cutoff=9.0, rfa=True,
                              kernel="cell")
    if name == "argon-npt":
        mol, par = argon()
        mol.box = np.full((3, 1), ARGON_L)
        return mol, par, dict(terms=["lj"], cutoff=9.0)
    if name == "water":
        mol, par, terms = water()
        return mol, par, dict(terms=terms, cutoff=7.3, rfa=True, switch_dist=6.0)
    if name == "tip4p":
        mol, par, terms = tip4p(spec["top"], spec["coords"], spec["L"])
        return mol, par, dict(terms=terms, cutoff=4.5, switch_dist=3.5, rfa=True)
    raise ValueError(name)


# ----------------------------------------------------------------------
# Rank functions
# ----------------------------------------------------------------------

def mesh_info(rank, axes, shape):
    mesh = make_mesh(axes=axes, shape=shape, device="cpu")
    return dict(shape=mesh.shape, coords=mesh.coords, size=mesh.size,
                backend=mesh.backend, device=str(mesh.device))


def run_md(rank, spec):
    """Build the spec's system on this rank, step it chunk by chunk, and
    return the final state, the per-chunk Epot, the last T and the
    thermostat's (and barostat's) conserved parts; spec["forces_kw"] adds
    Forces keywords to the system's. spec["mesh"] is None
    (no mesh: a one-process reference run on the rank) or (axes, shape,
    shard, mesh_axis)."""
    torch.set_num_threads(1)
    mol, par, fkw = system_of(spec)
    forces = Forces(par, precision="double", device="cpu", **dict(fkw, **spec.get("forces_kw", {})))
    nrep = spec.get("nrep", 1)
    system = System(mol.numAtoms, nrep, "double")
    system.set_positions(mol.coords)
    system.set_box(mol.box)
    system.set_velocities(spec["vel"])
    if "pos" in spec:
        system.set_positions(np.transpose(spec["pos"], (1, 2, 0)))
    if "box" in spec:
        system.set_box(np.asarray(spec["box"])[0])
    if "forces" in spec:
        system.set_forces(spec["forces"])
    ikw = dict(spec.get("integrator", {}))
    if spec.get("barostat"):
        from torchmd_tpu_torch.barostat import MTKBarostat

        ikw["barostat"] = MTKBarostat(*spec["barostat"][0], **spec["barostat"][1])
    if spec.get("mesh") is not None:
        axes, shape, shard, axis = spec["mesh"]
        ikw.update(mesh=make_mesh(axes=axes, shape=shape, device="cpu"), shard=shard,
                   mesh_axis=axis)
    integ = Integrator(system, forces, spec["timestep"], device="cpu", **ikw)
    if "thermo_aux" in spec:
        from torchmd_tpu_torch import interop

        aux, npt = interop.spatial_state_from_numpy(spec["thermo_aux"],
                                                    spec.get("npt_extra"))
        integ._thermo_aux = aux
        if npt is not None:
            integ.npt_state = npt
    epots, temps = [], []
    for _ in range(spec["chunks"]):
        _, ep, T = integ.step(niter=spec["niter"])
        epots.append(ep)
        temps.append(T)
    out = dict(pos=system.pos.copy(), vel=system.vel.copy(), box=system.box_diag.copy(),
               epot=np.asarray(epots), T=np.asarray(temps),
               thermo=integ.thermostat_energy())
    if spec.get("barostat"):
        out["npt"] = integ.npt_energy()
    if integ.mesh is not None:
        out["collectives"] = dict(integ.mesh.calls)
    return out


def collectives(rank, shape):
    """The mesh's collectives on small integer tensors: (coords, gather
    along sp, reduce-scatter along sp, sum along dp, OR along sp, the
    gradient of a differentiable gather, this rank's block of 6 replicas
    over dp, the default device or "raised" where make_mesh without a
    device raised)."""
    try:
        default = str(make_mesh(axes=("dp", "sp"), shape=shape).device)
    except RuntimeError:
        default = "raised"
    mesh = make_mesh(axes=("dp", "sp"), shape=shape, device="cpu")
    x = torch.full((2, 3), float(rank))
    gathered = mesh.all_gather(x, "sp")
    scattered = mesh.reduce_scatter(torch.arange(8.0).reshape(4, 2) * (rank + 1), "sp")
    summed = mesh.all_reduce(torch.tensor([float(rank)]), "dp")
    flag = mesh.any(torch.tensor(rank == 3), "sp")
    y = torch.tensor([[rank + 1.0]], requires_grad=True)
    (mesh.all_gather_d(y, "sp") ** 2).sum().backward()
    mine = shard_replicas(mesh, {"x": torch.arange(6.0)}, "dp")["x"]
    return (mesh.coords, gathered.numpy(), scattered.numpy(), summed.numpy(), bool(flag),
            y.grad.numpy(), mine.numpy(), default)


def _energy_system(spec):
    """(FFParams, config, reciprocal term or None) of an energy spec."""
    name = spec["system"]
    if name == "alanine":
        mol, par = alanine()
        f = Forces(par, terms=ALL_TERMS, precision="double", device="cpu", **ALANINE_NB)
        return f.ffparams, f.config, None
    if name == "alanine-ewald":
        mol, par = alanine()
        f = Forces(par, terms=ALL_TERMS, precision="double", device="cpu", elec="ewald",
                   cutoff=9.0, switch_dist=7.5)
        f.ensure_ewald(mol.box[:, 0])
        return f.ffparams, f.config, f._ewald
    if name == "argon-nbfix":
        mol, par = argon(0, ("lj", "electrostatics"))
        f = Forces(par, terms=["lj", "electrostatics"], precision="double", device="cpu",
                   cutoff=9.0, rfa=True)
        A, B = (torch.as_tensor(t) for t in spec["lj_ab"])
        return f.ffparams._replace(lj_ab=(A, B)), f.config, None
    raise ValueError(name)


def energy_forces(rank, spec):
    """`sharded_energy_fn` on this rank's mesh: ((B,) energies by the call,
    and (B,) energies with (B, N, 3) forces by `energy_forces`)."""
    torch.set_num_threads(1)
    mesh = make_mesh(axes=("dp", "sp"), shape=spec["shape"], device="cpu")
    ffp, cfg, ewald = _energy_system(spec)
    efn = sharded_energy_fn(ffp, cfg, mesh, ewald=ewald)
    pos = torch.as_tensor(spec["pos"])
    box = torch.as_tensor(spec["box"])
    e_call = efn(pos, box)
    e, f = efn.energy_forces(pos, box)
    return e_call.numpy(), e.numpy(), f.numpy()


def train_steps(rank, spec):
    """ForceMatchingTrainer steps (SGD) on the argon gas with perturbed LJ,
    on this rank's mesh (spec["shape"]) or none: (losses, the trained LJ
    rows)."""
    torch.set_num_threads(1)
    import functools

    from torchmd_tpu_torch.train import ForceMatchingTrainer

    mesh = None
    if spec.get("shape") is not None:
        mesh = make_mesh(axes=("dp", "sp"), shape=spec["shape"], device="cpu")
    mol, par = argon()
    f = Forces(par, terms=["lj"], precision="double", device="cpu", cutoff=9.0)
    ffp = f.ffparams._replace(lj_params=f.ffparams.lj_params * torch.tensor([[1.1, 1.3]],
                                                                            dtype=torch.float64))
    trainer = ForceMatchingTrainer(
        ffp, f.config, trainable=("lj",),
        optimizer=functools.partial(torch.optim.SGD, lr=spec["lr"]),
        energy_weight=spec.get("energy_weight", 0.0), mesh=mesh)
    state = trainer.init()
    losses = []
    t = torch.as_tensor
    for _ in range(spec.get("steps", 1)):
        state, loss = trainer.step(state, t(spec["pos"]), t(spec["box"]), t(spec["f_ref"]),
                                   t(spec["e_ref"]))
        losses.append(float(loss))
    return np.asarray(losses), state.params["lj"].detach().numpy()


# ----------------------------------------------------------------------
# Halo-exchange MD (test_torch_halo.py)
# ----------------------------------------------------------------------

def neighbour_shifts(rank, spec):
    """`Mesh.ppermute` of a rank-stamped tensor along both axes of a
    (dp, sp) mesh of spec["shape"], by shifts 1, -1 and 2, over
    spec["transport"]: (coords, {(axis, shift): received}, calls,
    bytes, transport)."""
    mesh = make_mesh(axes=("dp", "sp"), shape=spec["shape"], device="cpu",
                     transport=spec["transport"])
    x = torch.arange(6.0).reshape(2, 3) + 100.0 * rank
    got = {(axis, shift): mesh.ppermute(x, axis, shift).numpy()
           for axis in ("dp", "sp") for shift in (1, -1, 2)}
    return mesh.coords, got, dict(mesh.calls), dict(mesh.bytes), mesh.transport


def halo_inputs(spec):
    """(FFParams, ForceTermConfig, exclusion table, constraints, virtual
    sites) of a halo spec: the JAX package's FFParams as numpy
    (spec["ffp"], a dict) with its config (spec["cfg"]) and exclusion
    table, or a system built here (spec["system"], with SETTLE)."""
    from torchmd_tpu_torch import interop
    from torchmd_tpu_torch.constraints import build_constraint_spec
    from torchmd_tpu_torch.neighbors import build_exclusion_table
    from torchmd_tpu_torch.potentials import ForceTermConfig

    if "ffp" in spec:
        dtype = torch.float64 if spec.get("precision", "double") == "double" else torch.float32
        return (interop.ffparams_from_numpy(spec["ffp"], device=spec.get("device", "cpu"),
                                            dtype=dtype),
                ForceTermConfig(**spec["cfg"]), spec.get("excl"), None, None)
    mol, par, fkw = system_of(spec)
    forces = Forces(par, precision="double", device="cpu", **fkw)
    masses = np.asarray(par.masses, np.float64).reshape(-1, 1)
    cs = build_constraint_spec(par, masses, mode="settle", device="cpu", dtype=torch.float64)
    return (forces.ffparams, forces.config, build_exclusion_table(par, mol.numAtoms), cs,
            forces.vsites)


def run_halo(rank, spec):
    """A HaloMD run on this rank's mesh (spec["axes"], spec["shape"];
    the halo over spec["axis"]; on spec["device"], default the CPU): init
    from spec["pos"], spec["vel"]; the capacities of spec["plant"] set
    after init; spec["chunks"] calls of step(spec["niter"]). Returns the
    gathered state, the per-chunk (ekin, epot, T), the counters and the
    capacities before and after."""
    torch.set_num_threads(1)
    from torchmd_tpu_torch.parallel import HaloMD

    ffp, cfg, excl, cs, vsites = halo_inputs(spec)
    mesh = make_mesh(axes=spec["axes"], shape=spec.get("shape"),
                     device=spec.get("device", "cpu"))
    h = HaloMD(ffp, cfg, mesh, spec["box"], excl_table=excl, timestep=spec["timestep"],
               T=spec.get("T"), gamma=spec.get("gamma"), axis=spec["axis"],
               seed=spec.get("seed", 1), constraints=cs, vsites=vsites)
    h.init(spec["pos"], spec["vel"])
    if spec.get("plant"):
        h.spec = h.spec._replace(**spec["plant"])
    start = h.spec
    out = np.asarray([h.step(spec["niter"]) for _ in range(spec["chunks"])])
    pos, vel = h.gather()
    return dict(pos=pos, vel=vel, ekin=out[:, 0], epot=out[:, 1], T=out[:, 2],
                migrations=h.migrations, overflow_log=h.overflow_log, start=start,
                prep=(h.prep_overflows, h.prep_overflow_last),
                spec=h.spec, calls=dict(mesh.calls), bytes=dict(mesh.bytes))


def halo_prep_overflow(rank, spec):
    """HaloMD's two reads of the pair kernel's prep flag, this rank's set
    to a count of spec["planted"] + rank rows by hand (the plain pair
    stage has no cap and never sets it): set before a step (the per-step
    read), set by the one step's pair stage (the chunk end's read), then
    a step with the flag left alone. Each read that finds the flag counts
    it in `prep_overflows`, keeps (rows, rank) of the fullest cell in
    `prep_overflow_last` and clears it, and the step goes on. After each
    step: the two counters, the flag, and whether the state and the
    step's (ekin, epot, T) are finite."""
    torch.set_num_threads(1)
    from torchmd_tpu_torch.parallel import HaloMD

    ffp, cfg, excl, _, _ = halo_inputs(spec)
    mesh = make_mesh(axes=spec["axes"], shape=spec.get("shape"), device="cpu")
    h = HaloMD(ffp, cfg, mesh, spec["box"], excl_table=excl, timestep=spec["timestep"],
               axis=spec["axis"])
    h.init(spec["pos"], np.zeros_like(spec["pos"]))
    count, pair_stage = spec["planted"] + rank, h._forces

    def planted(*args):
        out = pair_stage(*args)
        h._prep_over.fill_(count)
        return out

    def stepped():
        out = h.step(1)
        pos, vel = h.gather()
        return dict(count=h.prep_overflows, last=h.prep_overflow_last,
                    flag=int(h._prep_over.sum()),
                    finite=bool(np.isfinite(out).all() and np.isfinite(pos).all()
                                and np.isfinite(vel).all()))

    h._prep_over.fill_(count)
    out = dict(step=stepped())
    h._forces = planted
    out["chunk"] = stepped()
    h._forces = pair_stage
    out["cleared"] = stepped()
    return out
