"""The port's dense MTK scan, its SHAKE constraint virial, the exact
Ewald sum and r-RESPA NPT against the JAX package at f64 on the CPU.

  - `EwaldRecip` on the solvated alanine dipeptide (688 atoms, the box of
    its ACEMD input, cutoff 9 A): `Forces(elec="ewald")` takes it below
    PME_AUTO_N atoms in both packages; energy and forces within 1e-10
    relative, the per-axis virial against jax.grad of E(s pos, s box);
  - the dense MTK scan (`_build_scan_npt`) on the same box with the
    exact Ewald sum and a Nose-Hoover chain, 2 x 10 steps: `settle`
    (SETTLE waters, SHAKE on the solute's hydrogen bonds) at 2 fs, and
    `hbonds` (SHAKE everywhere) with HMR 3 at 4 fs: positions within
    1e-8 A, the box within 1e-12 relative (the box's flexible waters
    need their constraints: their H-H bonds have no force constant);
  - MTK with `hbonds` on the TIP3P water box of tests/test_mtk.py:376
    (SHAKE pairs only), 2 x 10 steps; and the SHAKE virial, each
    cluster's atoms relative to its heaviest atom, against the JAX
    scans' absolute-position sum within 1e-8 relative;
  - r-RESPA NPT (mts 2, `_build_scan_npt_mts`) on the periodic stiff
    dimer gas of tests/test_mts.py, dense and cell paths, within 1e-8 A;
  - on the card (gpu marker): 10 dense MTK steps at f32 against the f64
    torch-op path on the card, positions within 1e-3 A.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from common import ALL_TERMS, load_system
from conftest import DATA_DIR

from torchmd_tpu import barostat as jbaro
from torchmd_tpu import constraints as jcon
from torchmd_tpu.ewald import EwaldRecip as JaxEwaldRecip
from torchmd_tpu.forces import Forces as JaxForces
from torchmd_tpu.integrator import Integrator as JaxIntegrator
from torchmd_tpu.parameters import Parameters
from torchmd_tpu.systems import System as JaxSystem
from torchmd_tpu.units import BOLTZMANN
from torchmd_tpu_torch import Forces, Integrator, MTKBarostat, System
from torchmd_tpu_torch import constraints as tcon
from torchmd_tpu_torch.ewald import EwaldRecip

torch.set_num_threads(1)

ALANINE_NB = dict(cutoff=9.0, switch_dist=7.5, elec="ewald")
PORT = (Forces, System, Integrator, MTKBarostat, dict(device="cpu"))
JAX = (JaxForces, JaxSystem, JaxIntegrator, jbaro.MTKBarostat, {})


@functools.lru_cache(maxsize=None)
def _alanine():
    mol, ff, _ = load_system(os.path.join(DATA_DIR, "prod_alanine_dipeptide_amber"))
    par = Parameters(ff, mol, ALL_TERMS, precision="double")
    m = np.asarray(par.masses, np.float64).reshape(-1)
    rs = np.random.RandomState(1)
    vel = rs.randn(1, mol.numAtoms, 3) * np.sqrt(BOLTZMANN * 300.0 / m.reshape(1, -1, 1))
    return mol, par, vel


def test_ewald_recip_matches_jax():
    mol, par, _ = _alanine()
    box = mol.box.reshape(-1)
    jf = JaxForces(par, terms=ALL_TERMS, precision="double", **ALANINE_NB)
    tf = Forces(par, terms=ALL_TERMS, precision="double", device="cpu", **ALANINE_NB)
    jrec, trec = jf.ensure_ewald(box), tf.ensure_ewald(box)
    assert isinstance(jrec, JaxEwaldRecip) and isinstance(trec, EwaldRecip)
    assert tuple(trec.cfg.kmax) == tuple(jrec.cfg.kmax) and trec.cfg.alpha == jrec.cfg.alpha
    pos = mol.coords[:, :, 0]
    e_j, f_j = jrec.energy_forces(jnp.asarray(pos), jnp.asarray(box))
    e_t, f_t, v_t = trec.energy_forces_virial(torch.as_tensor(pos), torch.as_tensor(box))
    assert abs(float(e_t) - float(e_j)) <= 1e-10 * abs(float(e_j))
    f_j = np.asarray(f_j)
    assert np.abs(f_t.numpy() - f_j).max() <= 1e-10 * np.abs(f_j).max()
    g = jax.grad(lambda s: jrec.energy(jnp.asarray(pos) * s, jnp.asarray(box) * s))(
        jnp.ones(3))
    np.testing.assert_allclose(v_t.numpy(), -np.asarray(g), rtol=1e-10)
    # the whole evaluation: per-term energies and forces of Forces.compute
    e_jf = jf.compute(mol.coords[:, :, 0][None], box[None], returnDetails=True)[0]
    e_tf = tf.compute(mol.coords[:, :, 0][None], box[None], returnDetails=True)[0]
    for k, w in e_jf.items():
        assert abs(e_tf[k] - w) <= 1e-9 * max(1.0, abs(w)), (k, e_tf[k], w)


def _alanine_npt(pkg, constraints, chunks=2, chunk=10):
    Fc, Sc, Ic, Bc, dev = pkg
    mol, par, vel = _alanine()
    forces = Fc(par, terms=ALL_TERMS, precision="double", **ALANINE_NB, **dev)
    s = Sc(mol.numAtoms, 1, "double")
    s.set_positions(mol.coords)
    s.set_box(mol.box)
    s.set_velocities(vel)
    timestep = 2.0
    if constraints == "hbonds":
        timestep = 4.0
        s.set_masses(jcon.repartition_hydrogen_masses(par.masses, mol.bonds, factor=3.0))
    forces.compute(s.pos, s.box, s.forces)
    integ = Ic(s, forces, timestep, T=300.0, thermostat="nhc", constraints=constraints,
               barostat=Bc(1.0, 300.0))
    out = [integ.step(niter=chunk) for _ in range(chunks)]
    return s, integ, out


@functools.lru_cache(maxsize=None)
def _jax_alanine_npt(constraints):
    s, integ, out = _alanine_npt(JAX, constraints)
    return (np.asarray(s.pos).copy(), np.asarray(s.box_diag).copy(), out,
            integ.thermostat_energy(), integ.npt_energy())


@pytest.mark.parametrize("constraints", ["settle", "hbonds"])
def test_dense_mtk_matches_jax(constraints):
    jpos, jbox, jout, jthermo, jnpt = _jax_alanine_npt(constraints)
    s, integ, out = _alanine_npt(PORT, constraints)
    assert integ.forces._cell_kernel is None and not integ._use_cell
    assert isinstance(integ.forces._ewald, EwaldRecip)
    assert integ.constraints.shake is not None
    mol = _alanine()[0]
    assert abs(s.box_diag[0, 0] / mol.box[0, 0] - 1.0) > 1e-6    # the box moved
    np.testing.assert_allclose(s.box_diag, jbox, rtol=1e-12)
    assert np.abs(s.pos - jpos).max() <= 1e-8
    for a, b in zip(jout, out):
        for x, y in zip(a, b):
            np.testing.assert_allclose(y, x, rtol=1e-9)
    np.testing.assert_allclose(integ.thermostat_energy(), jthermo, rtol=1e-9)
    np.testing.assert_allclose(integ.npt_energy(), jnpt, rtol=1e-9)


def _tip3p_npt(pkg, steps=10, chunks=2):
    """tests/test_mtk.py:376's system: the TIP3P water box with SHAKE on
    every hydrogen bond, 1 fs, MTK at 1 bar."""
    Fc, Sc, Ic, Bc, dev = pkg
    mol, ff, _ = load_system(os.path.join(DATA_DIR, "waterbox"))
    par = Parameters(ff, mol, ALL_TERMS, precision="double")
    forces = Fc(par, terms=ALL_TERMS, precision="double", cutoff=7.0, switch_dist=6.0,
                rfa=True, **dev)
    s = Sc(mol.numAtoms, 1, "double")
    s.set_positions(mol.coords)
    s.set_box(np.full((3, 1), 15.0))
    m = np.asarray(par.masses, np.float64).reshape(1, -1, 1)
    s.set_velocities(np.random.RandomState(6).randn(1, mol.numAtoms, 3)
                     * np.sqrt(BOLTZMANN * 300.0 / m))
    forces.compute(s.pos, s.box, s.forces)
    integ = Ic(s, forces, 1.0, T=300.0, thermostat="nhc", constraints="hbonds",
               barostat=Bc(1.0, 300.0, tau_fs=1000.0))
    out = [integ.step(niter=steps) for _ in range(chunks)]
    return s, integ, out


def test_mtk_shake_hbonds_matches_jax():
    js, jinteg, jout = _tip3p_npt(JAX)
    ts, tinteg, tout = _tip3p_npt(PORT)
    assert tinteg.constraints.shake is not None and tinteg.constraints.settle is None
    np.testing.assert_allclose(ts.box_diag, np.asarray(js.box_diag), rtol=1e-12)
    assert np.abs(ts.pos - np.asarray(js.pos)).max() <= 1e-8
    for a, b in zip(jout, tout):
        for x, y in zip(a, b):
            np.testing.assert_allclose(y, x, rtol=1e-9)
    err = float(tcon.max_constraint_error(tinteg.constraints.shake,
                                          torch.as_tensor(ts.pos[0])))
    assert err < 5e-5


def test_shake_virial_matches_the_absolute_sum():
    """One SHAKE projection of a box-scaled drift on the alanine box
    (hbonds: SHAKE pairs and SETTLE waters): the port's virial, relative
    within each cluster and water, against the JAX scans' absolute form
    sum f_con r, f_con = 2 m delta / drift^2."""
    mol, par, vel = _alanine()
    m = np.asarray(par.masses, np.float64).reshape(-1, 1)
    spec = tcon.build_constraint_spec(par, m, mode="hbonds")
    shake_only = tcon.build_constraint_spec(par, m, mode="hbonds")._replace(settle=None)
    assert spec.shake is not None
    pos0 = torch.as_tensor(mol.coords[:, :, 0])[None]
    drift = torch.tensor([[[0.041, 0.040, 0.042]]], dtype=torch.float64)
    scale = torch.tensor([1.0002, 0.9999, 1.0001], dtype=torch.float64)
    pos = pos0 * scale + torch.as_tensor(vel) * drift
    for c in (spec, shake_only):
        pos_c = tcon.apply_position_constraints(c, pos, pos0 * scale)
        delta = pos_c - pos
        mt = torch.as_tensor(m)
        got = tcon.constraint_virial(c, mt, delta, drift, pos_c)[0].numpy()
        f = 2.0 * m * delta[0].numpy() / (drift[0].numpy() ** 2)
        want = np.asarray(jnp.sum(jnp.asarray(f) * jnp.asarray(pos_c[0].numpy()), axis=0))
        assert np.abs(got).max() > 1.0
        np.testing.assert_allclose(got, want, rtol=1e-8)
    # the SHAKE clusters' anchors are their heavy atoms
    cs = spec.shake
    assert np.all(m[cs.anchor.numpy(), 0] > 3.5)


def _dimer_npt(pkg, kernel, mts=2, chunks=2, chunk=10):
    """tests/test_mtk.py's periodic stiff-dimer gas under r-RESPA MTK."""
    from test_mts import periodic_dimer_gas
    from test_torch_mts import DIMER_FF

    Fc, Sc, Ic, Bc, dev = pkg
    mol, par = periodic_dimer_gas()
    if pkg is PORT:
        from torchmd_tpu_torch.forcefields.ff_yaml import YamlForcefield
        from torchmd_tpu_torch.parameters import Parameters as TParameters

        par = TParameters(YamlForcefield(mol, DIMER_FF), mol, ["bonds", "lj"],
                          precision="double")
    forces = Fc(par, terms=["bonds", "lj"], precision="double", cutoff=6.5,
                kernel=kernel, **dev)
    s = Sc(mol.numAtoms, 1, "double")
    s.set_positions(mol.coords)
    s.set_box(mol.box)
    m = np.asarray(par.masses, np.float64).reshape(1, -1, 1)
    s.set_velocities(np.random.RandomState(5).randn(1, mol.numAtoms, 3)
                     * np.sqrt(BOLTZMANN * 200.0 / m))
    forces.compute(s.pos, s.box, s.forces)
    L = float(mol.box[0, 0])
    P = mol.numAtoms * BOLTZMANN * 200.0 / L**3 / jbaro.BAR_A3_TO_KCALMOL
    integ = Ic(s, forces, 2.0, T=200.0, thermostat="nhc", mts=mts,
               barostat=Bc(P, 200.0, tau_fs=400.0))
    out = [integ.step(niter=chunk) for _ in range(chunks)]
    return s, integ, out


@pytest.mark.parametrize("kernel", ["dense", "cell"])
def test_npt_mts_matches_jax(kernel):
    js, jinteg, jout = _dimer_npt(JAX, kernel)
    ts, tinteg, tout = _dimer_npt(PORT, kernel)
    assert (tinteg.forces._cell_kernel is not None) == (kernel == "cell")
    assert np.abs(ts.box_diag[0, 0] / 28.0 - 1.0) > 1e-5
    np.testing.assert_allclose(ts.box_diag, np.asarray(js.box_diag), rtol=1e-10)
    assert np.abs(ts.pos - np.asarray(js.pos)).max() <= 1e-8
    for a, b in zip(jout, tout):
        for x, y in zip(a, b):
            np.testing.assert_allclose(y, x, rtol=1e-9)
    np.testing.assert_allclose(tinteg.npt_energy(), jinteg.npt_energy(), rtol=1e-9)


@pytest.mark.gpu
def test_dense_mtk_on_the_card():
    """10 dense MTK steps with SHAKE on the card at f32 against the f64
    torch-op path on the card (the path launches no CUDA kernel)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mol, par, vel = _alanine()
    out = {}
    for prec in ("single", "double"):
        forces = Forces(par, terms=ALL_TERMS, precision=prec, device="cuda", **ALANINE_NB)
        s = System(mol.numAtoms, 1, prec)
        s.set_positions(mol.coords)
        s.set_box(mol.box)
        s.set_velocities(vel)
        s.set_masses(tcon.repartition_hydrogen_masses(par.masses, mol.bonds, 3.0))
        forces.compute(s.pos, s.box, s.forces)
        Integrator(s, forces, 4.0, T=300.0, thermostat="nhc", constraints="hbonds",
                   barostat=MTKBarostat(1.0, 300.0)).step(niter=10)
        out[prec] = s.pos.astype(np.float64)
    assert np.abs(out["single"] - out["double"]).max() <= 1e-3
