"""The port's SHAKE/RATTLE and hydrogen mass repartitioning against the
JAX package, at f64 on the CPU.

  - SHAKE and RATTLE, one call each on thrombin from a seeded
    displacement: positions and velocities within 1e-10;
  - the constraint sets of "hbonds", "allbonds" and "settle" (SETTLE plus
    SHAKE on the other hydrogen bonds) on thrombin and the solvated
    alanine dipeptide: identical pairs, targets, waters and ncon;
  - HMR at factor 3 equals the JAX package's masses and constraints;
  - the repaired fault: at factor 4 the JAX package picks the hydrogens
    from the repartitioned masses and constrains 588 bonds of thrombin,
    the port the 2,319 X-H bonds;
  - 20 NVE steps of the alanine box (PME, settle + SHAKE, HMR 3, 4 fs):
    positions within 1e-8 A of the JAX run, and SHAKE's error at the end;
  - the Integrator counts the SHAKE pairs in the degrees of freedom and
    takes MTK with SHAKE pairs (refused only with r-RESPA's reciprocal
    tier, as in the JAX package).
"""

from __future__ import annotations

import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from common import ALL_TERMS, load_system
from conftest import DATA_DIR

from torchmd_tpu import constraints as jcon
from torchmd_tpu.forces import Forces as JaxForces
from torchmd_tpu.integrator import Integrator as JaxIntegrator
from torchmd_tpu.parameters import Parameters
from torchmd_tpu.systems import System as JaxSystem
from torchmd_tpu.units import BOLTZMANN
from torchmd_tpu_torch import constraints as tcon
from torchmd_tpu_torch.barostat import MTKBarostat
from torchmd_tpu_torch.forces import Forces
from torchmd_tpu_torch.integrator import Integrator
from torchmd_tpu_torch.systems import System

torch.set_num_threads(1)

THROMBIN_XH = 2319  # thrombin-ligand's bonds with a hydrogen
JAX_HMR4_FAULT = 588  # what the JAX package constrains at HMR factor 4


def _par(name, terms=("bonds", "angles")):
    mol, ff, _ = load_system(os.path.join(DATA_DIR, name))
    return mol, Parameters(ff, mol, list(terms), precision="double")


@pytest.fixture(scope="module")
def thrombin():
    return _par("thrombin-ligand-amber")


def _masses(par):
    return np.asarray(par.masses, np.float64).reshape(-1)


def test_shake_and_rattle_match_jax(thrombin):
    mol, par = thrombin
    m = _masses(par)
    cj, ct = jcon.build_constraints(par, m), tcon.build_constraints(par, m)
    rs = np.random.RandomState(0)
    ref = mol.coords[:, :, 0].astype(np.float64)
    new = ref + 0.02 * rs.randn(*ref.shape)
    pj = np.asarray(jcon.shake_positions(cj, jnp.asarray(new), jnp.asarray(ref)))
    pt = tcon.shake_positions(ct, torch.as_tensor(new), torch.as_tensor(ref)).numpy()
    assert np.abs(pj - new).max() > 1e-2  # SHAKE moved the atoms
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-10)
    err = float(tcon.max_constraint_error(ct, torch.as_tensor(pt)))
    assert err == pytest.approx(float(jcon.max_constraint_error(cj, jnp.asarray(pj))),
                                abs=1e-12)
    assert err < 1e-6
    vel = 0.01 * rs.randn(*ref.shape)
    vj = np.asarray(jcon.rattle_velocities(cj, jnp.asarray(pj), jnp.asarray(vel)))
    vt = tcon.rattle_velocities(ct, torch.as_tensor(pj), torch.as_tensor(vel)).numpy()
    assert np.abs(vj - vel).max() > 1e-3
    np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-10)
    # a leading replica axis passes through
    two = tcon.shake_positions(ct, torch.as_tensor(np.stack([new, new])),
                               torch.as_tensor(np.stack([ref, ref]))).numpy()
    np.testing.assert_allclose(two[1], pt, rtol=0, atol=1e-14)


def _same_spec(sj, st):
    assert (sj is None) == (st is None)
    if sj is None:
        return
    assert st.ncon == sj.ncon
    assert (st.shake is None) == (sj.shake is None)
    if sj.shake is not None:
        np.testing.assert_array_equal(st.shake.pairs.numpy(), np.asarray(sj.shake.pairs))
        np.testing.assert_allclose(st.shake.r0.numpy(), np.asarray(sj.shake.r0), rtol=1e-15)
        np.testing.assert_allclose(st.shake.invm.numpy(), np.asarray(sj.shake.invm),
                                   rtol=1e-15)
    assert (st.settle is None) == (sj.settle is None)
    if sj.settle is not None:
        for f in ("oidx", "h1", "h2"):
            np.testing.assert_array_equal(getattr(st.settle, f).numpy(),
                                          np.asarray(getattr(sj.settle, f)))


@pytest.mark.parametrize("name", ["thrombin-ligand-amber", "prod_alanine_dipeptide_amber"])
@pytest.mark.parametrize("mode", ["hbonds", "allbonds", "settle"])
def test_constraint_sets_match_jax(name, mode, thrombin):
    mol, par = thrombin if name.startswith("thrombin") else _par(name)
    m = _masses(par)
    sj = jcon.build_constraint_spec(par, m, mode=mode)
    st = tcon.build_constraint_spec(par, m, mode=mode)
    _same_spec(sj, st)
    if name.startswith("thrombin") and mode == "hbonds":
        assert st.ncon == THROMBIN_XH
    if mode == "settle" and name.startswith("prod"):
        # SETTLE on the waters and SHAKE on the peptide's X-H bonds
        assert st.settle is not None and st.shake is not None


def test_hmr_factor3_matches_jax(thrombin):
    mol, par = thrombin
    m0 = _masses(par)
    mj = jcon.repartition_hydrogen_masses(m0, mol.bonds, factor=3.0)
    mt = tcon.repartition_hydrogen_masses(m0, mol.bonds, factor=3.0)
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_allclose(mt.sum(), m0.sum(), rtol=1e-12)
    # the JAX CLI writes the repartitioned masses into the parameters
    # (torchmd_tpu/run.py:259-264); the port keeps the force field's there
    pj = copy.copy(par)
    pj.masses = mj.reshape(np.shape(par.masses))
    for mode in ("hbonds", "settle"):
        _same_spec(jcon.build_constraint_spec(pj, mj, mode=mode),
                   tcon.build_constraint_spec(par, mt, mode=mode))
    with pytest.raises(ValueError, match="non-positive"):
        tcon.repartition_hydrogen_masses(m0, mol.bonds, factor=20.0)


def test_hmr_factor4_keeps_the_hydrogen_bonds(thrombin):
    """The repaired fault: the light atoms come from the force field's
    masses, not the repartitioned ones."""
    mol, par = thrombin
    m0 = _masses(par)
    m4 = tcon.repartition_hydrogen_masses(m0, mol.bonds, factor=4.0)
    pj = copy.copy(par)
    pj.masses = m4.reshape(np.shape(par.masses))
    assert jcon.build_constraint_spec(pj, m4, mode="hbonds").ncon == JAX_HMR4_FAULT
    st = tcon.build_constraint_spec(par, m4, mode="hbonds")
    assert st.ncon == THROMBIN_XH
    _same_spec(jcon.build_constraint_spec(par, m0, mode="hbonds"),
               st._replace(shake=st.shake._replace(invm=torch.as_tensor(
                   1.0 / m0.reshape(-1, 1)))))
    # SHAKE's inverse masses are the repartitioned ones
    np.testing.assert_allclose(st.shake.invm.numpy()[:, 0], 1.0 / m4, rtol=1e-15)


def _alanine_box():
    mol, ff, _ = load_system(os.path.join(DATA_DIR, "prod_alanine_dipeptide_amber"))
    par = Parameters(ff, mol, ALL_TERMS, precision="double")
    m = jcon.repartition_hydrogen_masses(_masses(par), mol.bonds, factor=3.0)
    rs = np.random.RandomState(1)
    vel = rs.randn(1, mol.numAtoms, 3) * np.sqrt(BOLTZMANN * 300.0 / m.reshape(1, -1, 1))
    return mol, par, m, vel


def _nve(system_cls, forces, integrator_cls, mol, m, vel):
    s = system_cls(mol.numAtoms, 1, "double")
    s.set_positions(mol.coords)
    s.set_box(mol.box)
    s.set_masses(m)
    s.set_velocities(vel)
    integ = integrator_cls(s, forces, 4.0, constraints="settle")
    out = [integ.step(niter=10) for _ in range(2)]
    return s, integ, out


def test_alanine_box_4fs_nve_matches_jax():
    mol, par, m, vel = _alanine_box()
    nb = dict(cutoff=9.0, switch_dist=7.5, elec="pme")
    js, _, jout = _nve(JaxSystem, JaxForces(par, terms=ALL_TERMS, precision="double", **nb),
                       JaxIntegrator, mol, m, vel)
    ts, integ, tout = _nve(System, Forces(par, terms=ALL_TERMS, precision="double",
                                          device="cpu", **nb),
                           Integrator, mol, m, vel)
    assert integ.constraints.shake is not None and integ.constraints.settle is not None
    np.testing.assert_allclose(ts.pos, js.pos, rtol=0, atol=1e-8)
    np.testing.assert_allclose(ts.vel, js.vel, rtol=0, atol=1e-8)
    for (ek_j, ep_j, t_j), (ek_t, ep_t, t_t) in zip(jout, tout):
        np.testing.assert_allclose(ek_t, ek_j, rtol=1e-9)
        np.testing.assert_allclose(ep_t, ep_j, rtol=1e-9)
        np.testing.assert_allclose(t_t, t_j, rtol=1e-9)
    pos = torch.as_tensor(ts.pos[0])
    assert float(tcon.max_constraint_error(integ.constraints.shake, pos)) < 1e-6
    assert float(tcon.max_settle_error(integ.constraints.settle, pos)) < 1e-8
    # degrees of freedom: 3 N - ncon
    n = mol.numAtoms
    assert integ._dof_scale == pytest.approx(3 * n / (3 * n - integ.constraints.ncon))


def test_mtk_with_shake_pairs_raises():
    """MTK with SHAKE pairs runs since the SHAKE virial was ported
    (test_torch_npt_dense.py); with the reciprocal tier of r-RESPA
    (`mts_recip`) it still raises, as in the JAX package, which has no
    virial form of the reciprocal impulse."""
    mol, par, m, vel = _alanine_box()
    forces = Forces(par, terms=ALL_TERMS, precision="double", device="cpu",
                    cutoff=9.0, switch_dist=7.5, elec="pme", kernel="cell")
    s = System(mol.numAtoms, 1, "double")
    s.set_positions(mol.coords)
    s.set_box(mol.box)
    with pytest.raises(NotImplementedError, match="mts_recip"):
        Integrator(s, forces, 2.0, constraints="settle", T=300.0, thermostat="nhc",
                   barostat=MTKBarostat(1.0, 300.0), mts=2, mts_recip=2)
    integ = Integrator(s, forces, 2.0, constraints="settle", T=300.0, thermostat="nhc",
                       barostat=MTKBarostat(1.0, 300.0))
    assert integ.constraints.shake is not None and integ._use_cell


@pytest.mark.gpu
def test_shake_and_rattle_on_the_card(thrombin):
    """SHAKE and RATTLE at f32 on the card against f64 on the CPU, from the
    seeded displacement: positions within 1e-4 A, residual within 10 f32
    ulps of the largest coordinate, velocities within 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mol, par = thrombin
    m = _masses(par)
    c64 = tcon.build_constraints(par, m)
    c32 = tcon.build_constraints(par, m, device="cuda", dtype=torch.float32)
    rs = np.random.RandomState(0)
    ref = mol.coords[:, :, 0].astype(np.float64)
    new = ref + 0.02 * rs.randn(*ref.shape)
    vel = 0.01 * rs.randn(*ref.shape)

    def card(a):
        return torch.as_tensor(a, dtype=torch.float32, device="cuda")

    p64 = tcon.shake_positions(c64, torch.as_tensor(new), torch.as_tensor(ref))
    p32 = tcon.shake_positions(c32, card(new), card(ref))
    np.testing.assert_allclose(p32.cpu().numpy(), p64.numpy(), rtol=0, atol=1e-4)
    ulp = float(np.spacing(np.float32(np.abs(new).max())))
    assert float(tcon.max_constraint_error(c64, p32.cpu().double())) <= 10 * ulp
    v64 = tcon.rattle_velocities(c64, p64, torch.as_tensor(vel))
    v32 = tcon.rattle_velocities(c32, card(p64.numpy()), card(vel))
    np.testing.assert_allclose(v32.cpu().numpy(), v64.numpy(), rtol=0, atol=1e-6)
