"""The port's spatially sharded paths against the JAX package at f64 on
the CPU, over gloo process groups of 2 and 4 ranks.

  - the plain versions of the dense pair kernel's row range and the cell
    kernel's slab against the JAX package's `rowblock_energy_forces` and
    `cell_nonbonded_energy_forces(slab=)`, in one process; the row
    ranges of a padded layout partition the full call's rows and
    energies, and the slabs of 2 and 4 ranks its forces and energies;
  - `Integrator(mesh=, shard="spatial")` on W = 2 ranks against the JAX
    package's spatial runs (torchmd_tpu.parallel.make_mesh(2) on the
    virtual CPU devices), at the JAX tests' own tolerances
    (tests/test_parallel.py:245-560): NVE and NHC on alanine dipeptide,
    the cell path's slabs on a charged argon gas, TIP4P/2005 with virtual
    sites, and SETTLE waters;
  - kernel='verlet' under spatial sharding (the row block, as the JAX
    package runs it) against the port's unsharded Verlet run;
  - spatial Langevin on W = 2 ranks (4: test_torch_parallel.py) against
    the port's unsharded run (the JAX package folds its noise key with the rank, the port draws
    the whole system's noise on every rank), bit for bit up to rounding;
  - `gpu`: the row range and the slab of the CUDA kernels against their
    plain versions, and the row range's rows bit for bit those of the
    full call.

The pool of ranks is spawned once (a module fixture); ranks run
`mesh_workers`, which imports no JAX.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import mesh_workers as mw
from torchmd_tpu_torch.ops import cell as tcell
from torchmd_tpu_torch.ops import nonbonded as kn
from torchmd_tpu_torch.parallel import launch
from torchmd_tpu_torch.parallel.spatial import padded_rows, slab
from torchmd_tpu_torch.units import BOLTZMANN

torch.set_num_threads(1)

SPATIAL = (("sp",), None, "spatial", "sp")


@pytest.fixture(scope="module")
def ranks2():
    with launch.Ranks(2, threads=1, timeout=300) as ranks:
        yield ranks


def velocities(masses, T, nrep=1, seed=0):
    """Maxwell-Boltzmann velocities from numpy (massless rows at rest)."""
    m = np.asarray(masses, np.float64).reshape(1, -1, 1)
    rs = np.random.RandomState(seed)
    std = np.sqrt(BOLTZMANN * T / np.where(m > 0, m, 1.0)) * (m > 0)
    return rs.randn(nrep, m.shape[1], 3) * std


def jax_run(mol, forces, vel, timestep, chunks, niter, mesh=False, **kw):
    """The JAX package's run from the same numpy start: final positions and
    the per-chunk Epot; with `mesh`, spatially sharded over 2 virtual
    devices."""
    from torchmd_tpu.integrator import Integrator
    from torchmd_tpu.parallel import make_mesh
    from torchmd_tpu.systems import System

    system = System(mol.numAtoms, 1, "double", "cpu")
    system.set_positions(mol.coords)
    system.set_box(mol.box)
    system.set_velocities(vel)
    if mesh:
        kw.update(mesh=make_mesh(2, axes=("sp",)), mesh_axis="sp", shard="spatial")
    integ = Integrator(system, forces, timestep, **kw)
    epots = [integ.step(niter=niter)[1] for _ in range(chunks)]
    return system.pos.copy(), np.asarray(epots), integ


# ----------------------------------------------------------------------
# The plain row range and slab, in one process
# ----------------------------------------------------------------------

def test_row_range_matches_jax_rowblock():
    """Every rank's tile range of a padded 2- and 4-rank layout: the plain
    pair kernel's rows equal the JAX row block (1e-12), and the ranges sum
    to the full call."""
    import jax.numpy as jnp
    from common import ALL_TERMS, load_system
    from conftest import DATA_DIR

    from torchmd_tpu.forces import Forces as JaxForces
    from torchmd_tpu.parallel.spatial import pad_ffparams_rows, rowblock_energy_forces
    from torchmd_tpu.parameters import Parameters

    from torchmd_tpu_torch.potentials import ForceTermConfig, make_ffparams

    mol, ff, nb = load_system(os.path.join(DATA_DIR, "prod_alanine_dipeptide_amber"))
    par = Parameters(ff, mol, ALL_TERMS, precision="double")
    jf = JaxForces(par, terms=ALL_TERMS, precision="double", **nb)
    cfg = ForceTermConfig(**jf.config._asdict())
    data = kn.prepare_nb_data(make_ffparams(par, dtype=torch.float64, device="cpu"))
    n = mol.numAtoms
    pos = torch.as_tensor(mol.coords[:, :, 0])
    box = torch.as_tensor(mol.box[:, 0])
    pot_full, f_full = kn.pair_terms_reference(data, cfg, pos, box)
    nt = -(-n // 32)
    for nsp in (2, 4):
        npad = padded_rows(n, nsp)
        rows = npad // nsp
        jffp = pad_ffparams_rows(jf.ffparams, npad)
        jpos = jnp.pad(jnp.asarray(pos.numpy()), ((0, npad - n), (0, 0)))
        total = {k: 0.0 for k in pot_full}
        for k in range(nsp):
            tiles = (min(k * rows // 32, nt), min(nt, (k + 1) * rows // 32))
            pot, f = kn.nonbonded_energy_forces(data, cfg, pos, box, rows=tiles)
            lo, hi = kn.row_span(n, tiles)
            np.testing.assert_array_equal(f.numpy(), f_full[lo:hi].numpy())
            if nsp == 4:
                # the JAX row block of the same padded rows
                jpot, jf_rows = rowblock_energy_forces(
                    jffp, jf.config, jpos[k * rows:(k + 1) * rows], jpos,
                    jnp.asarray(box.numpy()), k * rows)
                np.testing.assert_allclose(f.numpy(), np.asarray(jf_rows)[:hi - lo], atol=1e-12)
                for key in pot:
                    np.testing.assert_allclose(float(pot[key]), float(jpot[key]), rtol=1e-12,
                                               atol=1e-12)
            for key in pot:
                total[key] += float(pot[key])
        for key, v in pot_full.items():
            np.testing.assert_allclose(total[key], float(v), rtol=1e-12)
    with pytest.raises(ValueError, match="outside"):
        kn.nonbonded_energy_forces(data, cfg, pos, box, rows=(0, -(-n // 32) + 1))


def test_slab_matches_jax_cell_slab():
    """The cell kernel's plain slab against the JAX package's slab of
    `cell_nonbonded_energy_forces` on the 216-water box with the switch
    and the reaction field (1e-10), for every rank of 2 and 4; the slabs
    sum to the full call."""
    import jax
    from test_torch_cell import _setup

    from torchmd_tpu import neighbors as jnb

    jf, cfg, jk, jcl, jpos, jbox, port, _ = _setup("switch-rfa")
    data, tcfg, clcfg, cl, pos, box = port
    pot_full, f_full = tcell.cell_reference(*port)
    ncx = clcfg.ncells[0]
    for nsp in (2, 4):
        f_sum = torch.zeros_like(f_full)
        e_sum = {k: 0.0 for k in pot_full}
        # the slab's start is traced in the JAX package (lax.axis_index)
        jslab = jax.jit(lambda cx0, nloc=slab(ncx, nsp, 0)[1]: jnb.cell_nonbonded_energy_forces(
            jf.ffparams, cfg, jk.clcfg, jcl, jk.excl_table, jpos, jbox, slab=(cx0, nloc)))
        for k in range(nsp):
            sl = slab(ncx, nsp, k)
            pot, f = tcell.cell_energy_forces(data, tcfg, clcfg, cl, pos, box, slab=sl)
            jpot, jfrc = jslab(sl[0])
            np.testing.assert_allclose(f.numpy(), np.asarray(jfrc), atol=1e-10)
            for key in pot:
                np.testing.assert_allclose(float(pot[key]), float(jpot[key]), rtol=1e-10,
                                           atol=1e-10)
                e_sum[key] += float(pot[key])
            f_sum += f
        np.testing.assert_allclose(f_sum.numpy(), f_full.numpy(), atol=1e-10)
        for key, v in pot_full.items():
            np.testing.assert_allclose(e_sum[key], float(v), rtol=1e-12)


# ----------------------------------------------------------------------
# Spatial runs against the JAX package's
# ----------------------------------------------------------------------

def _alanine_jax():
    from common import ALL_TERMS, load_system
    from conftest import DATA_DIR

    from torchmd_tpu.forces import Forces as JaxForces
    from torchmd_tpu.parameters import Parameters

    mol, ff, nb = load_system(os.path.join(DATA_DIR, "prod_alanine_dipeptide_amber"))
    par = Parameters(ff, mol, ALL_TERMS, precision="double")
    return mol, par, JaxForces(par, terms=ALL_TERMS, precision="double", **nb)


@pytest.mark.parametrize("thermo", ["nve", "nhc"])
def test_spatial_alanine_matches_jax(ranks2, thermo):
    """Alanine dipeptide, 3 chunks of 4 steps: NVE (tests/test_parallel.py:
    245-270) and NHC (:371-400), positions within 1e-9 A and Epot within
    1e-9 relative of the JAX spatial run; the chain's energy too."""
    mol, par, jf = _alanine_jax()
    vel = velocities(par.masses, 300.0, seed=11)
    kw = dict(seed=4) if thermo == "nve" else dict(seed=4, T=300.0, thermostat="nhc", tau=50.0)
    jpos, jep, jinteg = jax_run(mol, jf, vel, 1.0, 3, 4, mesh=True, **kw)
    spec = dict(system="alanine", vel=vel, timestep=1.0, chunks=3, niter=4, integrator=kw,
                mesh=SPATIAL)
    for got in ranks2.run(mw.run_md, spec):
        assert np.abs(got["pos"] - jpos).max() <= 1e-9
        np.testing.assert_allclose(got["epot"].ravel(), jep.ravel(), rtol=1e-9)
        np.testing.assert_allclose(got["thermo"], jinteg.thermostat_energy(), rtol=1e-9,
                                   atol=1e-12)


def test_spatial_cell_slab_matches_jax(ranks2):
    """kernel='cell' on the charged argon gas (tests/test_parallel.py:
    421-466): each rank's slab of cell columns, reduce-scattered to rows;
    NVE within 1e-8 A and Epot within 1e-9 relative."""
    from conftest import SYSTEMS_DIR

    from torchmd_tpu.forcefields import ForceField
    from torchmd_tpu.forces import Forces as JaxForces
    from torchmd_tpu.io import Molecule
    from torchmd_tpu.parameters import Parameters

    mol = Molecule(os.path.join(SYSTEMS_DIR, "argon", "argon_start.pdb"))
    mol.charge = np.random.RandomState(0).randn(mol.numAtoms) * 0.05
    ff = ForceField.create(mol, os.path.join(SYSTEMS_DIR, "argon", "argon_forcefield.yaml"))
    par = Parameters(ff, mol, ["lj", "electrostatics"], precision="double")
    par.charges = mol.charge.copy()
    jf = JaxForces(par, terms=["lj", "electrostatics"], precision="double", cutoff=9.0,
                   rfa=True, kernel="cell")
    mol.box = np.full((3, 1), mw.ARGON_L)
    vel = velocities(par.masses, 120.0, seed=7)
    jpos, jep, _ = jax_run(mol, jf, vel, 5.0, 2, 5, mesh=True, seed=2)
    spec = dict(system="argon-cell", vel=vel, timestep=5.0, chunks=2, niter=5,
                integrator=dict(seed=2), mesh=SPATIAL)
    for got in ranks2.run(mw.run_md, spec):
        assert np.abs(got["pos"] - jpos).max() <= 1e-8
        np.testing.assert_allclose(got["epot"].ravel(), jep.ravel(), rtol=1e-9)


def test_spatial_tip4p_sites_match_jax(ranks2):
    """Eight TIP4P/2005 waters with their M sites (tests/test_parallel.py:
    469-523): sites snap on the gathered positions and spread after one
    more gather; 1e-10 against the JAX spatial run, sites snapped."""
    from test_gromacs import TIP4P2005_TOP, tip4p_water

    from torchmd_tpu.forcefields import ForceField
    from torchmd_tpu.forces import Forces as JaxForces
    from torchmd_tpu.io import Molecule
    from torchmd_tpu.parameters import Parameters

    top_text = TIP4P2005_TOP.replace("SOL 2", "SOL 8")
    coords = np.concatenate([tip4p_water(np.array([i, j, k]) * 5.2 + 1.2)
                             for i in range(2) for j in range(2) for k in range(2)])
    top = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"tip4p8_{os.getpid()}.top")
    with open(top, "w") as fh:
        fh.write(top_text)
    try:
        mol = Molecule(top)
        ff = ForceField.create(mol, top)
    finally:
        os.remove(top)
    mol.coords = coords[:, :, None]
    mol.box = np.full((3, 1), 10.4)
    terms = ["bonds", "lj", "electrostatics"]
    par = Parameters(ff, mol, terms, precision="double")
    jf = JaxForces(par, terms=terms, precision="double", cutoff=4.5, switch_dist=3.5, rfa=True)
    vel = velocities(par.masses, 150.0, seed=11)
    jpos, jep, _ = jax_run(mol, jf, vel, 0.5, 2, 5, mesh=True, seed=4)
    spec = dict(system="tip4p", top=top_text, coords=coords, L=10.4, vel=vel, timestep=0.5,
                chunks=2, niter=5, integrator=dict(seed=4), mesh=SPATIAL)
    got = ranks2.run(mw.run_md, spec)[0]
    assert np.abs(got["pos"] - jpos).max() <= 1e-10
    np.testing.assert_allclose(got["epot"].ravel(), jep.ravel(), rtol=1e-10)
    w = got["pos"][0].reshape(-1, 4, 3)
    a = 0.13193828
    m_site = w[:, 0] + a * (w[:, 1] - w[:, 0]) + a * (w[:, 2] - w[:, 0])
    np.testing.assert_allclose(w[:, 3], m_site, atol=1e-12)


def test_spatial_settle_matches_jax(ranks2):
    """SETTLE waters (tests/test_parallel.py:526-567): the projection on
    the gathered arrays; 1e-10 against the JAX spatial run and rigid O-H
    after the run."""
    from conftest import SYSTEMS_DIR

    from torchmd_tpu.constraints import build_constraint_spec
    from torchmd_tpu.forcefields import ForceField
    from torchmd_tpu.forces import Forces as JaxForces
    from torchmd_tpu.io import Molecule
    from torchmd_tpu.parameters import Parameters

    d = os.path.join(SYSTEMS_DIR, "water")
    mol = Molecule(os.path.join(d, "structure.psf"))
    mol.read(os.path.join(d, "structure.pdb"))
    ff = ForceField.create(mol, os.path.join(d, "water_forcefield.yaml"))
    terms = ["bonds", "angles", "lj", "electrostatics"]
    par = Parameters(ff, mol, terms, precision="double")
    jf = JaxForces(par, terms=terms, precision="double", cutoff=7.3, rfa=True, switch_dist=6.0)
    vel = velocities(par.masses, 300.0, seed=9)
    jpos, jep, _ = jax_run(mol, jf, vel, 2.0, 2, 4, mesh=True, seed=3, constraints="settle")
    spec = dict(system="water", vel=vel, timestep=2.0, chunks=2, niter=4,
                integrator=dict(seed=3, constraints="settle"), mesh=SPATIAL)
    got = ranks2.run(mw.run_md, spec)[0]
    assert np.abs(got["pos"] - jpos).max() <= 1e-10
    np.testing.assert_allclose(got["epot"].ravel(), jep.ravel(), rtol=1e-10)
    cs = build_constraint_spec(par, np.asarray(par.masses), mode="settle")
    pos = got["pos"][0]
    d_oh = np.linalg.norm(pos[cs.settle.oidx] - pos[cs.settle.h1], axis=1)
    np.testing.assert_allclose(d_oh, np.asarray(cs.settle.r_oh), atol=1e-8)


def test_spatial_langevin_matches_unsharded_port(ranks2):
    """Langevin on alanine: the noise is the whole system's, drawn alike on
    every rank and cut to the rank's rows, so W = 2 ranks give the
    unsharded port's trajectory (1e-12 A) and a sane T (W = 4:
    test_torch_parallel.py)."""
    langevin_matches_unsharded(ranks2)


def test_spatial_verlet_runs_the_row_block(ranks2):
    """kernel='verlet' under spatial sharding: the row block of the dense
    pair kernel, as the JAX package's spatial scan has it (no Verlet
    form), so W = 2 ranks give the unsharded Verlet run's trajectory
    (1e-9 A, Epot 1e-9 relative) with the pair terms in it."""
    mol, par = mw.alanine()
    vel = velocities(par.masses, 300.0, seed=5)
    spec = dict(system="alanine", vel=vel, timestep=1.0, chunks=2, niter=3,
                integrator=dict(seed=3), forces_kw=dict(kernel="verlet"))
    ref = ranks2.run(mw.run_md, dict(spec, mesh=None))[0]
    for got in ranks2.run(mw.run_md, dict(spec, mesh=SPATIAL)):
        assert np.abs(got["pos"] - ref["pos"]).max() <= 1e-9
        np.testing.assert_allclose(got["epot"], ref["epot"], rtol=1e-9)


def langevin_matches_unsharded(ranks):
    mol, par = mw.alanine()
    vel = velocities(par.masses, 300.0, seed=2)
    spec = dict(system="alanine", vel=vel, timestep=1.0, chunks=2, niter=3,
                integrator=dict(seed=3, gamma=1.0, T=300.0))
    ref = ranks.run(mw.run_md, dict(spec, mesh=None))[0]
    for got in ranks.run(mw.run_md, dict(spec, mesh=SPATIAL)):
        assert np.abs(got["pos"] - ref["pos"]).max() <= 1e-12
        np.testing.assert_allclose(got["epot"], ref["epot"], rtol=1e-12)
        assert 150.0 < float(got["T"][-1][0]) < 450.0


# ----------------------------------------------------------------------
# The CUDA kernels' row range and slab (on the card)
# ----------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_row_range_matches_plain_and_full_rows():
    """Each tile range of a 4-rank layout on alanine: the kernel's rows
    against the plain f64 version (the Pallas bars of tests/test_pallas.py),
    bit for bit the same rows of the full launch; ROW_LAUNCHES counts."""
    dev = _card()
    mol, par = mw.alanine()
    from torchmd_tpu_torch.forces import Forces

    f64 = Forces(par, terms=mw.ALL_TERMS, precision="double", device="cpu", **mw.ALANINE_NB)
    f32 = Forces(par, terms=mw.ALL_TERMS, precision="single", device=dev, **mw.ALANINE_NB)
    d64 = kn.prepare_nb_data(f64.ffparams)
    d32 = kn.prepare_nb_data(f32.ffparams)
    cfg = f64.config
    p64 = torch.as_tensor(mol.coords[:, :, 0])
    b64 = torch.as_tensor(mol.box[:, 0])
    p32, b32 = p64.to(dev, torch.float32), b64.to(dev, torch.float32)
    _, f_full = kn.nonbonded_energy_forces(d32, cfg, p32, b32)
    n = mol.numAtoms
    rows = padded_rows(n, 4) // 4
    for k in range(4):
        tiles = (k * rows // 32, min(-(-n // 32), (k + 1) * rows // 32))
        n0 = kn.ROW_LAUNCHES
        pot_k, f_k = kn.nonbonded_energy_forces(d32, cfg, p32, b32, rows=tiles)
        pot_p, f_p = kn.pair_terms_reference(d64, cfg, p64, b64, rows=tiles)
        torch.cuda.synchronize()
        assert kn.ROW_LAUNCHES == n0 + 1
        lo, hi = kn.row_span(n, tiles)
        assert torch.equal(f_k, f_full[lo:hi])
        for key in pot_p:
            assert abs(float(pot_k[key]) - float(pot_p[key])) <= 1e-4 * max(
                1.0, abs(float(pot_p[key])))
        err = float((f_k.double().cpu() - f_p).abs().max())
        assert err <= 1e-4 * max(1.0, float(f_p.abs().max()))


@pytest.mark.gpu
def test_cuda_cell_slab_matches_plain():
    """The cell kernel's slabs of 2 and 4 ranks on the 216-water box
    against the plain f64 slab (2e-5 energies, 5e-5 forces: the bars of
    test_torch_cell.py's kernel case), summing to the full launch;
    SLAB_LAUNCHES counts."""
    dev = _card()
    from test_torch_cell import _setup

    _, _, _, _, _, _, port, _ = _setup("ewald")
    data, cfg, clcfg, cl, pos, box = port
    data32 = tcell.CellData(**{k: (v.to(dev, torch.float32) if torch.is_tensor(v)
                                   and v.is_floating_point() else
                                   v.to(dev) if torch.is_tensor(v) else v)
                               for k, v in data._asdict().items()})
    cl32 = cl._replace(slots=cl.slots.to(dev), counts=cl.counts.to(dev),
                       ref_pos=cl.ref_pos.to(dev, torch.float32), overflow=cl.overflow.to(dev))
    p32, b32 = pos.to(dev, torch.float32), box.to(dev, torch.float32)
    _, f_full = tcell.cell_energy_forces(data32, cfg, clcfg, cl32, p32, b32)
    for nsp in (2, 4):
        f_sum = torch.zeros_like(f_full)
        for k in range(nsp):
            sl = slab(clcfg.ncells[0], nsp, k)
            n0 = tcell.SLAB_LAUNCHES
            pot_k, f_k = tcell.cell_energy_forces(data32, cfg, clcfg, cl32, p32, b32, slab=sl)
            pot_p, f_p = tcell.cell_reference(data, cfg, clcfg, cl, pos, box, slab=sl)
            torch.cuda.synchronize()
            assert tcell.SLAB_LAUNCHES == n0 + (sl[0] < clcfg.ncells[0])
            for key in pot_p:
                assert abs(float(pot_k[key]) - float(pot_p[key])) <= 2e-5 * max(
                    1.0, abs(float(pot_p[key])))
            assert float((f_k.double().cpu() - f_p).abs().max()) <= 5e-5 * max(
                1.0, float(f_p.abs().max()))
            f_sum += f_k
        assert float((f_sum - f_full).abs().max()) <= 5e-5 * max(1.0, float(f_full.abs().max()))
