"""The port's neural-network potential (`torchmd_tpu_torch.nnp`) against
the JAX package at f64 on the CPU.

  - the JAX weights carried across (`interop.nnp_params_from_numpy`):
    energies and forces within 1e-10 relative on the argon dimer and on
    the periodic 100-atom argon frame of tests/systems/argon (two
    species); one weight matrix carried transposed, the planted fault,
    must miss them;
  - `train_nnp`, 5 Adam steps on the dimer's LJ curve: the losses and
    every weight within 1e-9 relative of optax.adam's;
  - `NNPExternal` as the only term of the port's `Forces` and
    `Integrator`, 20 NVE steps of the dimer against the JAX package's
    (1e-10 A), and its batched `calculate`.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import SYSTEMS_DIR

from torchmd_tpu import nnp as jnnp
from torchmd_tpu.io import Molecule
from torchmd_tpu_torch import nnp as tnnp
from torchmd_tpu_torch.interop import nnp_params_from_numpy

torch.set_num_threads(1)

CFG = dict(n_species=2, cutoff=8.0, n_rbf=8, features=8, hidden=16)


def _models(cfg_kw=CFG, seed=0):
    jcfg, tcfg = jnnp.NNPConfig(**cfg_kw), tnnp.NNPConfig(**cfg_kw)
    jp = jnnp.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jp, tcfg, nnp_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg)


def _lj(d, sigma=3.4, eps=0.24):
    s6 = (sigma / d) ** 6
    return 4 * eps * (s6 * s6 - s6)


def _frames():
    """(name, species, pos, box) of the dimer and the argon frame."""
    mol = Molecule(os.path.join(SYSTEMS_DIR, "argon", "argon_start.pdb"))
    argon = mol.coords[:, :, 0].astype(np.float64)
    return [("dimer", np.zeros(2, np.int64), np.array([[0.0, 0, 0], [3.9, 0.2, -0.1]]), None),
            ("argon", np.arange(len(argon)) % 2, argon, np.full(3, 77.395))]


def _eval_both(jcfg, jp, tcfg, tp, species, pos, box):
    jb = None if box is None else jnp.asarray(box)
    e_j, g_j = jax.value_and_grad(
        lambda x: jnnp.nnp_energy(jp, jcfg, jnp.asarray(species), x, jb))(jnp.asarray(pos))
    x = torch.as_tensor(pos).requires_grad_(True)
    e_t = tnnp.nnp_energy(tp, tcfg, torch.as_tensor(species), x,
                          None if box is None else torch.as_tensor(box))
    (g_t,) = torch.autograd.grad(e_t, x)
    return (float(e_j), -np.asarray(g_j)), (float(e_t.detach()), -g_t.numpy())


@pytest.mark.parametrize("frame", range(2), ids=["dimer", "argon"])
def test_energy_and_forces_match_jax(frame):
    name, species, pos, box = _frames()[frame]
    (e_j, f_j), (e_t, f_t) = _eval_both(*_models(), species, pos, box)
    assert abs(e_t - e_j) <= 1e-10 * max(1.0, abs(e_j)), (name, e_t, e_j)
    assert np.abs(f_t - f_j).max() <= 1e-10 * max(1.0, np.abs(f_j).max())
    assert np.abs(f_j).max() > 1e-6                 # the frame has forces


def test_transposed_weights_must_fail():
    jcfg, jp, tcfg, _ = _models()
    bad = jax.tree_util.tree_map(np.asarray, jp)
    bad["mlp2"]["w"] = bad["mlp2"]["w"].T
    _, species, pos, box = _frames()[1]
    (e_j, f_j), (e_t, f_t) = _eval_both(jcfg, jp, tcfg, nnp_params_from_numpy(bad, tcfg),
                                        species, pos, box)
    assert abs(e_t - e_j) > 1e3 * 1e-10 * max(1.0, abs(e_j))


def _dimer_curve():
    dists = np.linspace(3.2, 7.5, 12)
    pos = np.zeros((len(dists), 2, 3))
    pos[:, 1, 0] = dists
    h = 1e-6
    dEdr = (_lj(dists + h) - _lj(dists - h)) / (2 * h)
    f = np.zeros_like(pos)
    f[:, 1, 0], f[:, 0, 0] = -dEdr, dEdr
    return pos, _lj(dists), f


def test_train_nnp_matches_optax():
    cfg_kw = dict(n_species=1, cutoff=8.0, n_rbf=6, features=6, hidden=12)
    jcfg, jp, tcfg, tp = _models(cfg_kw, seed=1)
    pos, e_ref, f_ref = _dimer_curve()
    species = np.zeros(2, np.int64)
    jp, jhist = jnnp.train_nnp(jp, jcfg, jnp.asarray(species), jnp.asarray(pos),
                               jnp.asarray(e_ref), jnp.asarray(f_ref), steps=5,
                               learning_rate=3e-3)
    tp, thist = tnnp.train_nnp(tp, tcfg, species, pos, e_ref, f_ref, steps=5,
                               learning_rate=3e-3)
    np.testing.assert_allclose(thist, jhist, rtol=1e-9)
    assert thist[-1] < thist[0]
    want = jax.tree_util.tree_map(np.asarray, jp)
    for name, got in tp.named_parameters():
        w = want
        for part in name.split("."):
            w = w[part]
        scale = max(1e-3, np.abs(w).max())
        assert np.abs(got.detach().numpy() - w).max() <= 1e-9 * scale, name


def _dimer_md(pkg, ext, steps=20):
    """The dimer's positions after `steps` NVE steps at 5 fs with the NNP
    as the only term."""
    mol = Molecule()
    mol.numAtoms = 2
    mol.atomtype = np.array(["Ar", "Ar"], dtype=object)
    mol.charge = np.zeros(2)
    mol.masses = np.array([39.95, 39.95])
    mol.coords = np.asarray([[0.0, 0, 0], [4.4, 0.1, 0]])[:, :, None]
    if pkg == "jax":
        from torchmd_tpu.forcefields.forcefield import NullForcefield
        from torchmd_tpu.forces import Forces
        from torchmd_tpu.integrator import Integrator
        from torchmd_tpu.parameters import Parameters
        from torchmd_tpu.systems import System
        kw, skw = dict(device="cpu"), ("cpu",)
    else:
        from torchmd_tpu_torch.forcefields.forcefield import NullForcefield
        from torchmd_tpu_torch.forces import Forces
        from torchmd_tpu_torch.integrator import Integrator
        from torchmd_tpu_torch.parameters import Parameters
        from torchmd_tpu_torch.systems import System
        kw, skw = dict(device="cpu"), ()
    par = Parameters(NullForcefield(mol), mol, [], precision="double")
    forces = Forces(par, terms=[], external=ext, precision="double",
                    **({} if pkg == "jax" else kw))
    system = System(2, 1, "double", *skw)
    system.set_positions(mol.coords)
    integ = Integrator(system, forces, timestep=5.0, **kw)
    integ.step(niter=steps)
    return np.asarray(system.pos[0], np.float64)


def test_nnp_external_drives_the_integrator_as_jax():
    jcfg, jp, tcfg, tp = _models(dict(n_species=1, cutoff=8.0, n_rbf=8, features=8,
                                      hidden=16), seed=2)
    species = np.zeros(2, np.int64)
    jext = jnnp.NNPExternal(jp, jcfg, species)
    text = tnnp.NNPExternal(tp, tcfg, species)
    want, got = _dimer_md("jax", jext), _dimer_md("torch", text)
    assert np.abs(want - np.asarray([[0.0, 0, 0], [4.4, 0.1, 0]])).max() > 1e-4
    assert np.abs(got - want).max() <= 1e-10
    pos = np.asarray([[[0.0, 0, 0], [4.0, 0, 0]]])
    e, f = text.calculate(pos, None)
    e_j, f_j = jext.calculate(pos, None)
    assert e.shape == (1,) and f.shape == (1, 2, 3)
    np.testing.assert_allclose(e.numpy(), np.asarray(e_j), rtol=1e-10)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_j), rtol=1e-9, atol=1e-12)
