"""The port's device mesh (`torchmd_tpu_torch.parallel`) against the JAX
package's (`torchmd_tpu.parallel`) at f64 on the CPU, over gloo process
groups of 2 and 4 ranks (one process per rank, `parallel.launch`).

  - `mesh_shape` splits 1..8 devices as the JAX `make_mesh` does, and
    `make_mesh` on 4 ranks places them as the JAX mesh's device array
    does; the collectives (gather, reduce-scatter, sum, OR and the
    differentiable gather's adjoint) give what they say;
  - `sharded_energy_fn` on a 2 x 2 mesh: energies and forces of alanine
    dipeptide against the JAX sharded function on make_mesh(4) (1e-10),
    and the NBFIX and Ewald cases of tests/test_parallel.py:294-368
    against the JAX package's dense totals (1e-10);
  - `ForceMatchingTrainer(mesh=)` on 2 x 2: loss and LJ rows after two
    SGD steps against the JAX sharded trainer (tests/test_parallel.py:
    178-216, 1e-10), and with an energy term against the port's
    unsharded trainer;
  - `Integrator(mesh=, shard="replica")` on W = 2: 4 replicas under
    Langevin and CSVR equal the unsharded port's run (the noise is drawn
    for all replicas on every rank), and NHC the JAX replica-sharded run;
  - spatial MTK on W = 2 against the JAX spatial MTK run on the argon gas
    (tests/test_parallel.py:570-610's tolerances), a JAX spatial MTK run
    handed to the port mid-run (`interop.spatial_state_from_numpy`), and
    spatial Langevin on W = 4 against the unsharded port;
  - the options the JAX package refuses raise here too, and a mesh that
    is not a `Mesh` raises TypeError.

Pools of ranks are spawned once per world size (module fixtures); ranks
run `mesh_workers`, which imports no JAX.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import mesh_workers as mw
from test_torch_spatial import SPATIAL, langevin_matches_unsharded, velocities
from torchmd_tpu_torch.parallel import launch
from torchmd_tpu_torch.parallel.mesh import Mesh, mesh_shape

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ranks2():
    with launch.Ranks(2, threads=1, timeout=300) as ranks:
        yield ranks


@pytest.fixture(scope="module")
def ranks4():
    with launch.Ranks(4, threads=1, timeout=300) as ranks:
        yield ranks


def test_mesh_shape_matches_jax():
    from torchmd_tpu.parallel import make_mesh

    for n in range(1, 9):
        for axes in (("dp", "sp"), ("dp",)):
            assert mesh_shape(n, axes) == tuple(make_mesh(n, axes=axes).shape.values()), (n, axes)
    assert mesh_shape(8, shape=(4, 2)) == tuple(make_mesh(8, shape=(4, 2)).shape.values())
    with pytest.raises(ValueError, match="does not split"):
        mesh_shape(6, shape=(4, 2))


def test_make_mesh_and_collectives(ranks4):
    """Rank r sits where the JAX mesh puts device r (a row-major reshape);
    the collectives act along the named lines; the mesh's device defaults
    to the card, and without one make_mesh asks for a device."""
    from torchmd_tpu.parallel import make_mesh

    jmesh = make_mesh(4)
    out = ranks4.run(mw.collectives, (2, 2))
    for r, (coords, gathered, scattered, summed, flag, grad, mine, default) in enumerate(out):
        assert default == (f"cuda:{r % torch.cuda.device_count()}"
                           if torch.cuda.is_available() else "raised")
        where = np.argwhere(np.vectorize(lambda d: d.id)(jmesh.devices) == r)[0]
        assert (coords["dp"], coords["sp"]) == tuple(where)
        line = [2 * coords["dp"] + k for k in range(2)]   # the ranks of this sp line
        np.testing.assert_array_equal(gathered, np.repeat(np.asarray(line, float), 2)[:, None]
                                      * np.ones((4, 3)))
        block = sum((k + 1) * np.arange(8.0).reshape(4, 2) for k in line)
        np.testing.assert_array_equal(scattered, block[2 * coords["sp"]:2 * coords["sp"] + 2])
        np.testing.assert_array_equal(summed, [coords["sp"] + (coords["sp"] + 2)])
        assert flag == (coords["dp"] == 1)
        # the objective sums every rank's sum of squares of the gather:
        # d/dy = 2 y x (ranks of the line)
        np.testing.assert_allclose(grad, [[2.0 * (r + 1) * 2]])
        np.testing.assert_array_equal(mine, np.arange(6.0)[3 * coords["dp"]:3 * coords["dp"] + 3])


def _alanine_batch(B, seed=0, scale=0.02):
    from common import ALL_TERMS, load_system
    from conftest import DATA_DIR

    from torchmd_tpu.forces import Forces as JaxForces
    from torchmd_tpu.parameters import Parameters

    mol, ff, nb = load_system(os.path.join(DATA_DIR, "prod_alanine_dipeptide_amber"))
    par = Parameters(ff, mol, ALL_TERMS, precision="double")
    base = mol.coords[:, :, 0]
    pos = base[None] + scale * np.random.RandomState(seed).randn(B, *base.shape)
    box = np.tile(mol.box[:, 0][None], (B, 1))
    return mol, par, nb, pos, box


def test_sharded_energy_and_forces_match_jax(ranks4):
    """Alanine on dp x sp = 2 x 2, 4 jittered conformations: energies and
    forces on every rank against the JAX sharded energy and its gradient
    (tests/test_parallel.py:39-81), 1e-10."""
    import jax
    import jax.numpy as jnp
    from common import ALL_TERMS

    from torchmd_tpu.forces import Forces as JaxForces
    from torchmd_tpu.parallel import make_mesh, sharded_energy_fn

    mol, par, nb, pos, box = _alanine_batch(4)
    jf = JaxForces(par, terms=ALL_TERMS, precision="double", **nb)
    efn = sharded_energy_fn(jf.ffparams, jf.config, make_mesh(4, shape=(2, 2)))
    jpos, jbox = jnp.asarray(pos), jnp.asarray(box)
    e_j = np.asarray(jax.jit(efn)(jpos, jbox))
    f_j = -np.asarray(jax.jit(jax.grad(lambda p: jnp.sum(efn(p, jbox))))(jpos))
    spec = dict(system="alanine", shape=(2, 2), pos=pos, box=box)
    for e_call, e, f in ranks4.run(mw.energy_forces, spec):
        np.testing.assert_allclose(e_call, e_j, rtol=1e-10)
        np.testing.assert_allclose(e, e_j, rtol=1e-10)
        assert np.abs(f - f_j).max() <= 1e-10 * max(1.0, np.abs(f_j).max())


def test_sharded_energy_nbfix_and_ewald(ranks4):
    """The NBFIX A/B tables on a charged argon gas and the Ewald real and
    reciprocal sum on alanine (tests/test_parallel.py:294-368) against the
    JAX package's dense totals, 1e-10."""
    import jax
    import jax.numpy as jnp
    from common import ALL_TERMS
    from conftest import SYSTEMS_DIR

    from torchmd_tpu.forcefields import ForceField
    from torchmd_tpu.forces import Forces as JaxForces
    from torchmd_tpu.io import Molecule
    from torchmd_tpu.parameters import Parameters
    from torchmd_tpu.potentials import compute_potentials, total_energy

    mol, par, _, pos, box = _alanine_batch(2, seed=1)
    jf = JaxForces(par, terms=ALL_TERMS, precision="double", elec="ewald", cutoff=9.0,
                   switch_dist=7.5)
    jf.ensure_ewald(np.asarray(mol.box[:, 0]))

    def dense(p, b):
        pot = compute_potentials(jf.ffparams, p, b, jf.config)
        return sum(jax.tree_util.tree_leaves(pot)) + jf._ewald.energy(p, b)

    e_j = np.asarray(jax.jit(jax.vmap(dense))(jnp.asarray(pos), jnp.asarray(box)))
    spec = dict(system="alanine-ewald", shape=(2, 2), pos=pos, box=box)
    for e_call, _, _ in ranks4.run(mw.energy_forces, spec):
        np.testing.assert_allclose(e_call, e_j, rtol=1e-10)

    amol = Molecule(os.path.join(SYSTEMS_DIR, "argon", "argon_start.pdb"))
    amol.charge = np.random.RandomState(0).randn(amol.numAtoms) * 0.05
    ff = ForceField.create(amol, os.path.join(SYSTEMS_DIR, "argon", "argon_forcefield.yaml"))
    apar = Parameters(ff, amol, ["lj", "electrostatics"], precision="double")
    apar.charges = amol.charge.copy()
    af = JaxForces(apar, terms=["lj", "electrostatics"], precision="double", cutoff=9.0,
                   rfa=True)
    prm = np.asarray(af.ffparams.lj_params)
    sig_ij = 0.5 * (prm[:, 0][:, None] + prm[:, 0][None, :])
    B_t = 4 * np.sqrt(np.abs(prm[:, 1][:, None] * prm[:, 1][None, :])) * sig_ij**6
    A_t = B_t * sig_ij**6
    A_t[0, 0] *= 1.3
    B_t[0, 0] *= 0.8
    ffp = af.ffparams._replace(lj_ab=(jnp.asarray(A_t), jnp.asarray(B_t)))
    apos = np.tile(amol.coords[:, :, 0][None], (2, 1, 1))
    abox = np.full((2, 3), mw.ARGON_L)
    e_j = np.asarray(jax.jit(jax.vmap(lambda p, b: total_energy(ffp, p, b, af.config)))(
        jnp.asarray(apos), jnp.asarray(abox)))
    spec = dict(system="argon-nbfix", shape=(2, 2), pos=apos, box=abox, lj_ab=(A_t, B_t))
    for e_call, _, _ in ranks4.run(mw.energy_forces, spec):
        np.testing.assert_allclose(e_call, e_j, rtol=1e-10)


def _argon_training_batch(B=4):
    from conftest import SYSTEMS_DIR

    from torchmd_tpu.io import Molecule

    mol = Molecule(os.path.join(SYSTEMS_DIR, "argon", "argon_start.pdb"))
    base = mol.coords[:, :, 0]
    pos = base[None] + 0.05 * np.random.RandomState(3).randn(B, *base.shape)
    box = np.full((B, 3), mw.ARGON_L)
    f_ref = 0.01 * np.random.RandomState(4).randn(*pos.shape)
    return mol, pos, box, f_ref


def test_sharded_trainer_matches_jax(ranks4):
    """Two SGD steps of the sharded trainer on 2 x 2 against the JAX
    sharded trainer (tests/test_parallel.py:178-216): losses and LJ rows
    within 1e-10 relative on every rank."""
    import jax.numpy as jnp
    import optax
    from conftest import SYSTEMS_DIR

    from torchmd_tpu.forcefields import ForceField
    from torchmd_tpu.forces import Forces as JaxForces
    from torchmd_tpu.parallel import make_mesh
    from torchmd_tpu.parameters import Parameters
    from torchmd_tpu.train import ForceMatchingTrainer

    mol, pos, box, f_ref = _argon_training_batch()
    ff = ForceField.create(mol, os.path.join(SYSTEMS_DIR, "argon", "argon_forcefield.yaml"))
    par = Parameters(ff, mol, ["lj"], precision="double")
    jf = JaxForces(par, terms=["lj"], precision="double", cutoff=9.0)
    ffp = jf.ffparams._replace(lj_params=jf.ffparams.lj_params * jnp.asarray([[1.1, 1.3]]))
    tr = ForceMatchingTrainer(ffp, jf.config, trainable=("lj",), optimizer=optax.sgd(1e-3),
                              mesh=make_mesh(4, shape=(2, 2)))
    state, losses = tr.init(), []
    for _ in range(2):
        state, loss = tr.step(state, jnp.asarray(pos), jnp.asarray(box), jnp.asarray(f_ref))
        losses.append(float(loss))
    lj = np.asarray(state.params["lj"])
    spec = dict(shape=(2, 2), lr=1e-3, steps=2, pos=pos, box=box, f_ref=f_ref,
                e_ref=np.zeros(len(pos)))
    for got_losses, got_lj in ranks4.run(mw.train_steps, spec):
        np.testing.assert_allclose(got_losses, losses, rtol=1e-10)
        np.testing.assert_allclose(got_lj, lj, rtol=1e-10)


def test_sharded_trainer_energy_term_matches_unsharded(ranks4):
    """With an energy term (its all-reduce's adjoint carries 1/sp of it on
    each sp rank): the 2 x 2 trainer equals the port's unsharded one."""
    _, pos, box, f_ref = _argon_training_batch()
    spec = dict(lr=1e-3, steps=2, pos=pos, box=box, f_ref=f_ref, energy_weight=1e-3,
                e_ref=np.linspace(-5.0, 5.0, len(pos)))
    ref_losses, ref_lj = ranks4.run(mw.train_steps, spec)[0]
    for got_losses, got_lj in ranks4.run(mw.train_steps, dict(spec, shape=(2, 2))):
        np.testing.assert_allclose(got_losses, ref_losses, rtol=1e-10)
        np.testing.assert_allclose(got_lj, ref_lj, rtol=1e-10)


def test_replica_sharding_matches_unsharded_and_jax(ranks2):
    """4 replicas of the small water box over dp = 2: Langevin (a T
    ladder) and CSVR equal the unsharded port (every replica's noise drawn
    on every rank, 1e-12 A), and NHC equals the JAX replica-sharded
    Integrator (tests/test_parallel.py:219-242, 1e-9 A)."""
    replica = (("dp",), None, "replica", "dp")
    wpar = mw.water()[1]
    wvel = velocities(wpar.masses, 300.0, nrep=4, seed=5)
    for kw in (dict(seed=4, gamma=1.0, T=np.array([280.0, 300.0, 320.0, 340.0])),
               dict(seed=4, T=300.0, thermostat="csvr", tau=20.0)):
        spec = dict(system="water", vel=wvel, nrep=4, timestep=1.0, chunks=2, niter=3,
                    integrator=kw)
        ref = ranks2.run(mw.run_md, dict(spec, mesh=None))[0]
        for got in ranks2.run(mw.run_md, dict(spec, mesh=replica)):
            assert np.abs(got["pos"] - ref["pos"]).max() <= 1e-12
            np.testing.assert_allclose(got["epot"], ref["epot"], rtol=1e-12)

    from conftest import SYSTEMS_DIR

    from torchmd_tpu.forcefields import ForceField
    from torchmd_tpu.forces import Forces as JaxForces
    from torchmd_tpu.integrator import Integrator
    from torchmd_tpu.io import Molecule
    from torchmd_tpu.parallel import make_mesh
    from torchmd_tpu.parameters import Parameters
    from torchmd_tpu.systems import System

    d = os.path.join(SYSTEMS_DIR, "water")
    mol = Molecule(os.path.join(d, "structure.psf"))
    mol.read(os.path.join(d, "structure.pdb"))
    ff = ForceField.create(mol, os.path.join(d, "water_forcefield.yaml"))
    terms = ["bonds", "angles", "lj", "electrostatics"]
    jf = JaxForces(Parameters(ff, mol, terms, precision="double"), terms=terms,
                   precision="double", cutoff=7.3, rfa=True, switch_dist=6.0)
    kw = dict(seed=4, T=300.0, thermostat="nhc", tau=50.0)
    system = System(mol.numAtoms, 4, "double", "cpu")
    system.set_positions(mol.coords)
    system.set_box(mol.box)
    system.set_velocities(wvel)
    jinteg = Integrator(system, jf, 1.0, mesh=make_mesh(2, axes=("dp",)), **kw)
    jep = [jinteg.step(niter=3)[1] for _ in range(2)]
    spec = dict(system="water", vel=wvel, nrep=4, timestep=1.0, chunks=2, niter=3,
                integrator=kw, mesh=replica)
    for got in ranks2.run(mw.run_md, spec):
        assert np.abs(got["pos"] - system.pos).max() <= 1e-9
        np.testing.assert_allclose(got["epot"], np.asarray(jep), rtol=1e-9)
        np.testing.assert_allclose(got["thermo"], jinteg.thermostat_energy(), rtol=1e-9)


def _argon_npt_jax():
    from test_mtk import _argon_npt

    from torchmd_tpu.barostat import MTKBarostat
    from torchmd_tpu.observables import ideal_gas_pressure

    mol, par, forces, system = _argon_npt(nrep=1, seed=6)
    P = ideal_gas_pressure(mol.numAtoms, 120.0, mw.ARGON_L**3)
    return mol, par, forces, system, ((4.0 * P, 120.0), dict(tau_fs=2000.0)), MTKBarostat


def test_spatial_mtk_matches_jax(ranks2):
    """Spatial MTK with NHC on the argon gas at 4x its natural pressure,
    2 chunks of 10 steps, against the JAX spatial MTK run: box 1e-9
    relative, positions 1e-7 A, Epot 1e-8 relative (tests/
    test_parallel.py:570-610), and the barostat moved the box."""
    from torchmd_tpu.integrator import Integrator
    from torchmd_tpu.parallel import make_mesh

    mol, par, forces, system, baro, MTK = _argon_npt_jax()
    vel, frc = system.vel.copy(), system.forces.copy()
    jinteg = Integrator(system, forces, timestep=2.0, T=120.0, thermostat="nhc",
                        barostat=MTK(*baro[0], **baro[1]), seed=7,
                        mesh=make_mesh(2, axes=("sp",)), mesh_axis="sp", shard="spatial")
    jep = [jinteg.step(niter=10)[1] for _ in range(2)]
    spec = dict(system="argon-npt", vel=vel, forces=frc, timestep=2.0, chunks=2, niter=10,
                integrator=dict(seed=7, T=120.0, thermostat="nhc"), barostat=baro,
                mesh=SPATIAL)
    for got in ranks2.run(mw.run_md, spec):
        np.testing.assert_allclose(got["box"], system.box_diag, rtol=1e-9)
        assert np.abs(got["pos"] - system.pos).max() <= 1e-7
        np.testing.assert_allclose(got["epot"], np.asarray(jep), rtol=1e-8)
        np.testing.assert_allclose(got["npt"], jinteg.npt_energy(), rtol=1e-8)
        assert np.all(got["box"] < mw.ARGON_L)


def test_spatial_mtk_continues_a_jax_run(ranks2):
    """A JAX spatial MTK run handed to the port's spatial run after 10
    steps (the System's rows, the particle chain, v_eps and the barostat
    chain through `interop.spatial_state_from_numpy`): both continue alike
    for 10 more (the tolerances above)."""
    from torchmd_tpu.integrator import Integrator
    from torchmd_tpu.parallel import make_mesh

    mol, par, forces, system, baro, MTK = _argon_npt_jax()
    jinteg = Integrator(system, forces, timestep=2.0, T=120.0, thermostat="nhc",
                        barostat=MTK(*baro[0], **baro[1]), seed=7,
                        mesh=make_mesh(2, axes=("sp",)), mesh_axis="sp", shard="spatial")
    jinteg.step(niter=10)
    v_eps, aux_b, _ = jinteg._npt_extra
    spec = dict(system="argon-npt", pos=system.pos.copy(), vel=system.vel.copy(),
                forces=system.forces.copy(), box=system.box_diag.copy(), timestep=2.0,
                chunks=1, niter=10, integrator=dict(seed=7, T=120.0, thermostat="nhc"),
                barostat=baro, mesh=SPATIAL,
                thermo_aux={k: np.asarray(v) for k, v in jinteg._thermo_aux.items()},
                npt_extra=(np.asarray(v_eps), {k: np.asarray(v) for k, v in aux_b.items()}))
    want = jinteg.step(niter=10)[1]
    for got in ranks2.run(mw.run_md, spec):
        np.testing.assert_allclose(got["box"], system.box_diag, rtol=1e-9)
        assert np.abs(got["pos"] - system.pos).max() <= 1e-7
        np.testing.assert_allclose(got["epot"].ravel(), want, rtol=1e-8)


def test_spatial_langevin_on_four_ranks(ranks4):
    """Spatial Langevin on W = 4 equals the unsharded port (1e-12 A)."""
    langevin_matches_unsharded(ranks4)


def test_mesh_options_raise_where_jax_raises():
    """A mesh of one rank (no process group needed): TypeError for a mesh
    that is not a Mesh, and the JAX package's refusals for the spatial
    path (torchmd_tpu/integrator.py:221-227, :381-419)."""
    from torchmd_tpu_torch.barostat import MTKBarostat
    from torchmd_tpu_torch.forces import Forces
    from torchmd_tpu_torch.integrator import Integrator
    from torchmd_tpu_torch.systems import System
    from torchmd_tpu_torch.train import ForceMatchingTrainer

    mesh = Mesh(("sp",), (1,), "cpu", "gloo", 0, {})
    mol, par = mw.argon()

    def make(nrep=1, **fkw):
        system = System(mol.numAtoms, nrep, "double")
        system.set_positions(mol.coords)
        system.set_box(np.full((3, 1), mw.ARGON_L))
        return system, Forces(par, terms=["lj"], precision="double", device="cpu",
                              cutoff=9.0, **fkw)

    system, forces = make()
    with pytest.raises(TypeError, match="Mesh"):
        Integrator(system, forces, 1.0, mesh=object())
    with pytest.raises(TypeError, match="Mesh"):
        ForceMatchingTrainer(forces.ffparams, forces.config, mesh=object())
    with pytest.raises(ValueError, match="nreplicas=1"):
        Integrator(*make(nrep=2), 1.0, mesh=mesh, mesh_axis="sp", shard="spatial")
    with pytest.raises(NotImplementedError, match="mts"):
        Integrator(system, forces, 1.0, mesh=mesh, mesh_axis="sp", shard="spatial", mts=2)
    baro = MTKBarostat(1.0, 120.0)
    with pytest.raises(NotImplementedError, match="row-block"):
        Integrator(*make(kernel="cell"), 1.0, T=120.0, thermostat="nhc", barostat=baro,
                   mesh=mesh, mesh_axis="sp", shard="spatial")
    with pytest.raises(ValueError, match="must divide"):
        Integrator(*make(nrep=3), 1.0, mesh=Mesh(("dp",), (2,), "cpu", "gloo", 0, {}))
    with pytest.raises(ValueError, match="shard="):
        Integrator(system, forces, 1.0, mesh=mesh, shard="rows")
