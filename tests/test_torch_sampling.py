"""The port's collective variables, umbrella biases, WHAM and
well-tempered metadynamics against the JAX package at f64 on the CPU.

  - the ligand of tests/data/ligand-amber (52 atoms): distance, angle,
    dihedral and (mass-weighted, boxed) COM-distance CVs and their
    gradients (1e-7 relative); `HarmonicBias` (also periodic) as the
    external of `Forces`, energies and forces against the JAX
    `Forces.compute` (1e-7);
  - `wham` on the same sampled windows gives the JAX package's PMF (1e-10);
  - `MetaDynamics` on the ligand's first-last atom distance, 20 steps in
    chunks of 7 and 13 with a hill every 5 global steps, both packages'
    Gaussian draws patched to the same values: the CV series and
    positions within 1e-8 A, the bias grid within 1e-10, `nhills` and
    `free_energy` equal; the bias grid and its counters handed across by
    `interop.metadynamics_state_from_numpy` continue the JAX run. A hill
    deposited one step late must fail the comparison.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from common import ALL_TERMS, load_system
from conftest import DATA_DIR
from test_torch_remd import patch_draws

from torchmd_tpu import cv as jcv
from torchmd_tpu.forces import Forces as JaxForces
from torchmd_tpu.metadynamics import MetaDynamics as JaxMetaDynamics
from torchmd_tpu.parameters import Parameters
from torchmd_tpu.systems import System as JaxSystem
from torchmd_tpu_torch import Forces, System
from torchmd_tpu_torch import cv as tcv
from torchmd_tpu_torch.interop import metadynamics_state_from_numpy
from torchmd_tpu_torch.metadynamics import MetaDynamics

torch.set_num_threads(1)

TOL = 1e-7


def _ligand():
    mol, ff, _ = load_system(os.path.join(DATA_DIR, "ligand-amber"))
    par = Parameters(ff, mol, ALL_TERMS, precision="double")
    return mol, par


def _cvs(par):
    n = len(par.masses)
    ga, gb = np.arange(0, n // 2), np.arange(n // 2, n)
    return {
        "distance": (jcv.distance_cv(0, n - 1), tcv.distance_cv(0, n - 1)),
        "angle": (jcv.angle_cv(0, 5, 11), tcv.angle_cv(0, 5, 11)),
        "dihedral": (jcv.dihedral_cv(0, 5, 11, 17), tcv.dihedral_cv(0, 5, 11, 17)),
        "com": (jcv.com_distance_cv(ga, gb), tcv.com_distance_cv(ga, gb)),
        "com-mass": (jcv.com_distance_cv(ga, gb, masses=par.masses),
                     tcv.com_distance_cv(ga, gb, masses=par.masses)),
    }


@pytest.mark.parametrize("box", [None, 9.0])
@pytest.mark.parametrize("name", ["distance", "angle", "dihedral", "com", "com-mass"])
def test_cv_values_and_gradients_match_jax(name, box):
    mol, par = _ligand()
    jfn, tfn = _cvs(par)[name]
    pos = mol.coords[:, :, 0] + 0.05 * np.random.RandomState(0).randn(mol.numAtoms, 3)
    jbox = None if box is None else jnp.full(3, box)
    tbox = None if box is None else torch.full((3,), box, dtype=torch.float64)
    jv, jg = jax.value_and_grad(lambda p: jfn(p, jbox))(jnp.asarray(pos))
    p = torch.as_tensor(pos).requires_grad_(True)
    tv = tfn(p, tbox)
    (tg,) = torch.autograd.grad(tv, p)
    assert abs(float(tv.detach()) - float(jv)) <= TOL * max(1.0, abs(float(jv)))
    assert float(np.abs(tg.numpy() - np.asarray(jg)).max()) <= TOL * max(
        1.0, float(np.abs(np.asarray(jg)).max()))


@pytest.mark.parametrize("periodic", [False, True])
def test_harmonic_bias_through_forces_matches_jax(periodic):
    mol, par = _ligand()
    name = "dihedral" if periodic else "com-mass"
    jfn, tfn = _cvs(par)[name]
    center = 3.0 if periodic else 1.0
    jb = jcv.HarmonicBias(jfn, 12.0, center, periodic=periodic)
    tb = tcv.HarmonicBias(tfn, 12.0, center, periodic=periodic)
    pos = mol.coords[:, :, 0][None] + 0.05 * np.random.RandomState(1).randn(2, mol.numAtoms, 3)
    jf = JaxForces(par, terms=ALL_TERMS, precision="double", external=jb)
    tf = Forces(par, terms=ALL_TERMS, precision="double", device="cpu", external=tb)
    jfrc, tfrc = np.zeros_like(pos), np.zeros_like(pos)
    want = jf.compute(pos, None, jfrc, returnDetails=True)
    got = tf.compute(pos, None, tfrc, returnDetails=True)
    for w, g in zip(want, got):
        for k in w:
            assert abs(g[k] - w[k]) <= TOL * max(1.0, abs(w[k])), (k, g[k], w[k])
    assert np.abs(tfrc - jfrc).max() <= TOL * max(1.0, np.abs(jfrc).max())
    e, f = tb.calculate(torch.as_tensor(pos), None)
    je, jg = jb.calculate(pos, None)
    np.testing.assert_allclose(e.numpy(), je, rtol=1e-12)
    np.testing.assert_allclose(f.numpy(), jg, rtol=1e-10, atol=1e-12)


def test_wham_matches_jax():
    rs = np.random.RandomState(2)
    centers = np.linspace(-1.0, 1.0, 5)
    series = [c + rs.randn(400) * 0.3 for c in centers]
    want = jcv.wham(series, centers, 20.0, T=300.0, nbins=30)
    got = tcv.wham(series, centers, 20.0, T=300.0, nbins=30)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=0)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-10, atol=1e-10)


def _metad(pkg, chunks=(7, 13), state=None):
    mol, par = _ligand()
    n = mol.numAtoms
    if pkg == "jax":
        forces = JaxForces(par, terms=ALL_TERMS, precision="double")
        system, cv, M = JaxSystem(n, 1, "double"), jcv.distance_cv(0, n - 1), JaxMetaDynamics
    else:
        forces = Forces(par, terms=ALL_TERMS, precision="double", device="cpu")
        system, cv, M = System(n, 1, "double"), tcv.distance_cv(0, n - 1), MetaDynamics
    system.set_positions(mol.coords)
    m = np.asarray(par.masses, np.float64).reshape(1, -1, 1)
    system.set_velocities(np.random.RandomState(3).randn(1, n, 3) * np.sqrt(0.6 / m))
    forces.compute(system.pos, system.box, system.forces)
    metad = M(system, forces, cv, 1.0, T=300.0, gamma=5.0, grid=(5.0, 15.0, 201),
              sigma=0.3, height=0.4, stride=5, bias_factor=8.0)
    if state is not None:
        system.pos[:], system.vel[:], system.forces[:] = state["pos"], state["vel"], state["frc"]
        metadynamics_state_from_numpy(metad, state["bias"], state["steps"], state["nhills"])
    cvs = np.concatenate([np.asarray(metad.run(c)) for c in chunks])
    return system, metad, cvs


def _metad_gap(monkeypatch):
    patch_draws(monkeypatch)
    js, jm, jcvs = _metad("jax")
    ts, tm, tcvs = _metad("port")
    assert jm.nhills == 4
    return (float(np.abs(tcvs - jcvs).max()), float(np.abs(ts.pos - np.asarray(js.pos)).max()),
            float(np.abs(tm.bias.numpy() - np.asarray(jm.bias)).max()), tm, jm)


def test_metadynamics_matches_jax(monkeypatch):
    d_cv, d_pos, d_bias, tm, jm = _metad_gap(monkeypatch)
    assert d_cv <= 1e-8 and d_pos <= 1e-8 and d_bias <= 1e-10, (d_cv, d_pos, d_bias)
    assert tm.nhills == jm.nhills
    for a, b in zip(tm.free_energy(), jm.free_energy()):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-10)


def test_late_hill_fails(monkeypatch):
    """A hill one step late (after global steps 5, 10, ... rather than 4,
    9, ...) moves the grid and the trajectory off the JAX package's."""
    monkeypatch.setattr(MetaDynamics, "_deposits_after",
                        lambda self, i: i > 0 and i % self.stride == 0)
    d_cv, d_pos, d_bias, _, _ = _metad_gap(monkeypatch)
    assert d_bias > 1e-3, d_bias


def test_metadynamics_handed_over_from_jax(monkeypatch):
    """The JAX run's state after 12 steps (grid, step count, hills) handed
    to the port continues as the JAX run does."""
    patch_draws(monkeypatch)
    js, jm, _ = _metad("jax", chunks=(12,))
    state = dict(pos=np.array(js.pos), vel=np.array(js.vel), frc=np.array(js.forces),
                 bias=np.array(jm.bias), steps=jm._step_count, nhills=jm.nhills)
    jm.run(8)
    ts, tm, _ = _metad("port", chunks=(8,), state=state)
    assert tm.nhills == jm.nhills == 4
    assert np.abs(ts.pos - np.asarray(js.pos)).max() <= 1e-8
    assert np.abs(tm.bias.numpy() - np.asarray(jm.bias)).max() <= 1e-10
