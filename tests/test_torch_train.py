"""The port's force-matching trainer (`torchmd_tpu_torch.train`) against
the JAX package at f64 on the CPU.

  - `split_trainable` selects the same tensors as the JAX package, and
    its rebuild puts them back;
  - `ForceMatchingTrainer` on examples/train_cg.py's recipe (the 20-bead
    CG chain of tests/systems/cg, bonds + angles + repulsioncg, perturbed
    bonds, angles and LJ, Adam at 2.5e-2, energy weight 1e-4), 8 jittered
    conformations, 5 steps: losses and parameters within 1e-9 relative of
    the JAX trainer with optax.adam(2.5e-2);
  - the double-backward trap: the loss's parameter gradient through LJ +
    electrostatics on benzamidine (excluded pairs, the diagonal) is
    finite and equals the JAX package's (1e-9 relative);
  - the planted fault: a rebuild that ignores the trained tensors (stale
    parameters) must leave the JAX trajectory; `mesh=` takes a
    `parallel.Mesh` (tests/test_torch_parallel.py) and raises TypeError
    for anything else.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from common import load_system
from conftest import DATA_DIR, SYSTEMS_DIR

from torchmd_tpu import train as jtrain
from torchmd_tpu.forcefields import ForceField
from torchmd_tpu.forces import Forces as JaxForces
from torchmd_tpu.io import Molecule
from torchmd_tpu.parameters import Parameters
from torchmd_tpu.potentials import total_energy as jax_total_energy
from torchmd_tpu_torch import Forces
from torchmd_tpu_torch import train as ttrain
from torchmd_tpu_torch.interop import ffparams_from_numpy

torch.set_num_threads(1)

TERMS = ["bonds", "angles", "repulsioncg"]
TRAINABLE = ("bonds", "angles", "lj")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=1)
def _cg():
    """(JAX ffp_true, JAX cfg, pos (B, N, 3), f_ref, e_ref) of the CG recipe
    with B = 8 conformations."""
    cgdir = os.path.join(SYSTEMS_DIR, "cg")
    mol = Molecule(os.path.join(cgdir, "cg_structure.psf"))
    mol.read(os.path.join(cgdir, "cg_structure.xtc"))
    ff = ForceField.create(mol, os.path.join(cgdir, "forcefield.yaml"))
    par = Parameters(ff, mol, TERMS, precision="double")
    jf = JaxForces(par, terms=TERMS, precision="double", cutoff=9.0, exclusions=("bonds",))
    rs = np.random.RandomState(0)
    base = mol.coords[:, :, 0].astype(np.float64)
    pos = base[None] + 0.25 * rs.randn(8, *base.shape)
    box = jnp.zeros((8, 3))
    efn = jax.vmap(lambda p, b: jax_total_energy(jf.ffparams, p, b, jf.config))
    e_ref = np.array(efn(jnp.asarray(pos), box))
    f_ref = -np.array(jax.grad(lambda p: efn(p, box).sum())(jnp.asarray(pos)))
    return jf.ffparams, jf.config, pos, f_ref, e_ref


def _perturbed(ffp):
    return ffp._replace(
        bonds=ffp.bonds._replace(params=ffp.bonds.params * jnp.asarray([[1.4, 1.05]])),
        angles=ffp.angles._replace(params=ffp.angles.params * jnp.asarray([[0.7, 0.95]])),
        lj_params=ffp.lj_params * 1.2)


def _port_cfg(cfg):
    from torchmd_tpu_torch.potentials import ForceTermConfig

    return ForceTermConfig(**cfg._asdict())


def test_split_trainable_matches_jax():
    ffp, _, _, _, _ = _cg()
    want, jrebuild = jtrain.split_trainable(ffp, TRAINABLE + ("charges",))
    tffp = ffparams_from_numpy(_np(ffp))
    got, rebuild = ttrain.split_trainable(tffp, TRAINABLE + ("charges",))
    assert set(got) == set(want) == {"bonds", "angles", "lj", "charges"}
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    new = rebuild({k: v * 2.0 for k, v in got.items()})
    np.testing.assert_array_equal(new.bonds.params.numpy(), 2.0 * np.asarray(ffp.bonds.params))
    np.testing.assert_array_equal(new.lj_params.numpy(), 2.0 * np.asarray(ffp.lj_params))
    assert new.angles.idx is tffp.angles.idx
    assert set(ttrain.split_trainable(tffp, ("dihedrals", "1-4"))[0]) == set()


def _jax_run(steps):
    ffp, cfg, pos, f_ref, e_ref = _cg()
    tr = jtrain.ForceMatchingTrainer(_perturbed(ffp), cfg, trainable=TRAINABLE,
                                     optimizer=optax.adam(2.5e-2), energy_weight=1e-4)
    state, losses = tr.init(), []
    box = jnp.zeros((len(pos), 3))
    for _ in range(steps):
        state, loss = tr.step(state, jnp.asarray(pos), box, jnp.asarray(f_ref),
                              jnp.asarray(e_ref))
        losses.append(float(loss))
    return _np(state.params), losses


def _torch_run(steps, stale=False):
    ffp, cfg, pos, f_ref, e_ref = _cg()
    start = ffparams_from_numpy(_np(_perturbed(ffp)))
    tr = ttrain.ForceMatchingTrainer(
        start, _port_cfg(cfg), trainable=TRAINABLE,
        optimizer=functools.partial(torch.optim.Adam, lr=2.5e-2), energy_weight=1e-4)
    if stale:
        tr._rebuild = lambda params: start
    state, losses = tr.init(), []
    t = torch.as_tensor
    for _ in range(steps):
        state, loss = tr.step(state, t(pos), torch.zeros(len(pos), 3, dtype=torch.float64),
                              t(f_ref), t(e_ref))
        losses.append(float(loss))
    assert state.step == steps
    return {k: v.detach().numpy() for k, v in state.params.items()}, losses


def test_trainer_matches_jax():
    want, jl = _jax_run(5)
    got, tl = _torch_run(5)
    np.testing.assert_allclose(tl, jl, rtol=1e-9)
    assert tl[-1] < tl[0]
    for k in want:
        assert np.abs(got[k] - want[k]).max() <= 1e-9 * np.abs(want[k]).max(), k


def test_stale_parameters_must_fail():
    _, jl = _jax_run(5)
    _, tl = _torch_run(5, stale=True)
    assert abs(tl[-1] - jl[-1]) > 1e3 * 1e-9 * abs(jl[-1])


def test_double_backward_through_pairs_is_finite_and_matches_jax():
    """d(loss)/d(lj, charges) with the forces in the loss, through the
    dense masked pair terms (the diagonal and the excluded pairs held out
    by where), at f64."""
    mol, ff, _ = load_system(os.path.join(DATA_DIR, "benzamidine-amber"))
    terms = ["bonds", "angles", "lj", "electrostatics"]
    par = Parameters(ff, mol, terms, precision="double")
    jf = JaxForces(par, terms=terms, precision="double", cutoff=9.0)
    tf = Forces(par, terms=terms, precision="double", cutoff=9.0, device="cpu")
    rs = np.random.RandomState(1)
    base = mol.coords[:, :, 0].astype(np.float64)
    pos = base[None] + 0.05 * rs.randn(2, *base.shape)
    f_ref = rs.randn(*pos.shape)
    e_ref = rs.randn(2)
    box = np.zeros((2, 3))
    jt = jtrain.ForceMatchingTrainer(jf.ffparams, jf.config, trainable=("lj", "charges"),
                                     energy_weight=1e-2)
    want = jax.grad(jt.loss_fn)(jt.init().params, jnp.asarray(pos), jnp.asarray(box),
                                jnp.asarray(f_ref), jnp.asarray(e_ref))
    tt = ttrain.ForceMatchingTrainer(tf.ffparams, tf.config, trainable=("lj", "charges"),
                                     energy_weight=1e-2)
    params = tt.init().params
    loss = tt.loss_fn(params, torch.as_tensor(pos), torch.as_tensor(box),
                      torch.as_tensor(f_ref), torch.as_tensor(e_ref))
    grads = torch.autograd.grad(loss, list(params.values()))
    for (k, p), g in zip(params.items(), grads):
        g = g.numpy()
        assert np.all(np.isfinite(g)) and np.abs(g).max() > 0, k
        w = np.asarray(want[k])
        assert np.abs(g - w).max() <= 1e-9 * np.abs(w).max(), k


def test_mesh_raises():
    ffp, cfg, _, _, _ = _cg()
    with pytest.raises(TypeError, match="parallel.Mesh"):
        ttrain.ForceMatchingTrainer(ffparams_from_numpy(_np(ffp)), _port_cfg(cfg),
                                    mesh=object())
