"""The port's GB/OBC implicit solvent (`torchmd_tpu_torch.gb`) against the
JAX package's at f64 on the CPU.

  - the ligand of tests/data/ligand-amber (52 atoms, the prmtop's RADII
    and SCREEN): Born radii, `energy_fn` and the analytic
    `energy_forces_fn` equal the JAX package's (1e-7 relative per
    quantity), with and without a cutoff and a box; the analytic forces
    equal autograd of the port's own energy (1e-10 of max |F|), and a
    planted error in the HCT derivative of the third pass fails that;
  - `make_gbsa` reads the same radii and screening factors (and
    `interop.gbsa_from_numpy` carries the JAX term across), and
    `default_radii` gives the same element defaults;
  - GB as the external of `Forces` (the kernel path's plain versions and
    the dense torch-op path, one replica and a ladder through `ef_batch`)
    gives the JAX `Forces.compute`'s per-term energies and forces (1e-7);
  - on the card (gpu marker): GB at f32 against the CPU's f64.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from common import ALL_TERMS, load_system
from conftest import DATA_DIR

from torchmd_tpu import gb as jgb
from torchmd_tpu.external import JaxExternal
from torchmd_tpu.forces import Forces as JaxForces
from torchmd_tpu.parameters import Parameters
from torchmd_tpu_torch import Forces
from torchmd_tpu_torch import gb as tgb
from torchmd_tpu_torch.interop import gbsa_from_numpy

torch.set_num_threads(1)

TOL = 1e-7


def _ligand():
    mol, ff, _ = load_system(os.path.join(DATA_DIR, "ligand-amber"))
    par = Parameters(ff, mol, ALL_TERMS, precision="double")
    return mol, par


def _pos(mol, seed=0, scale=0.05):
    p = mol.coords[:, :, 0].astype(np.float64)
    return p + scale * np.random.RandomState(seed).randn(*p.shape)


def _pair(mol, par, **kw):
    return (jgb.make_gbsa(par, mol, **kw), tgb.make_gbsa(par, mol, device="cpu", **kw))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale, (
        float(np.abs(got - want).max()), scale)


CASES = {"plain": (None, None), "cutoff": (6.0, None), "cutoff-box": (6.0, 40.0)}


@pytest.mark.parametrize("case", list(CASES))
def test_gb_terms_match_jax(case):
    cutoff, L = CASES[case]
    mol, par = _ligand()
    jg, tg = _pair(mol, par, cutoff=cutoff)
    pos = _pos(mol)
    box = None if L is None else np.full(3, L)
    jbox = None if box is None else jnp.asarray(box)
    tbox = None if box is None else torch.as_tensor(box)
    tp = torch.as_tensor(pos)
    _close(tg.born_radii(tp, tbox).numpy(), jg.born_radii(jnp.asarray(pos), jbox))
    carried = gbsa_from_numpy(jg)
    _close(float(carried.energy_fn(tp, tbox)), float(tg.energy_fn(tp, tbox)), tol=1e-14)
    _close(float(tg.energy_fn(tp, tbox)), float(jg.energy_fn(jnp.asarray(pos), jbox)))
    je, jf = jg.energy_forces_fn(jnp.asarray(pos), jbox)
    te, tf = tg.energy_forces_fn(tp, tbox)
    _close(float(te), float(je))
    _close(tf.numpy(), np.asarray(jf))


def _analytic_vs_autograd(g, pos, box=None):
    p = torch.as_tensor(pos).requires_grad_(True)
    (grad,) = torch.autograd.grad(g.energy_fn(p, box), p)
    e, f = g.energy_forces_fn(torch.as_tensor(pos), box)
    assert float(e) == pytest.approx(float(g.energy_fn(torch.as_tensor(pos), box)), rel=1e-12)
    return float((f + grad).abs().max()) / float(grad.abs().max())


@pytest.mark.parametrize("cutoff", [None, 6.0])
def test_analytic_forces_equal_autograd(cutoff, monkeypatch):
    """The written-out d(HCT)/dr of pass 3 against autograd of the energy;
    a planted 1e-6 relative error in it must fail the same bar."""
    mol, par = _ligand()
    g = tgb.make_gbsa(par, mol, cutoff=cutoff, device="cpu")
    pos = _pos(mol, seed=1)
    assert _analytic_vs_autograd(g, pos) <= 1e-10
    good = tgb._hct_dr
    monkeypatch.setattr(tgb, "_hct_dr", lambda r, rho, S: good(r, rho, S) * (1.0 + 1e-6))
    assert _analytic_vs_autograd(g, pos) > 1e-10


def test_make_gbsa_reads_prmtop_radii_and_defaults():
    mol, par = _ligand()
    jg, tg = _pair(mol, par)
    for name in ("charges", "radii", "screen"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(), np.asarray(getattr(jg, name)))
    elements = ["H", "C", "N", "O", "S", "P", "F", "Xx"]
    for a, b in zip(tgb.default_radii(elements), jgb.default_radii(elements)):
        np.testing.assert_array_equal(a, b)
    assert (tg.eps_in, tg.eps_out, tg.sa) == (jg.eps_in, jg.eps_out, jg.sa)


@pytest.mark.parametrize("kernel", ["auto", "dense"])
def test_gb_external_through_forces_matches_jax(kernel):
    """GB as the external of Forces: per-term energies and forces of two
    replicas (one `ef_batch` ladder) against the JAX Forces.compute."""
    mol, par = _ligand()
    jg, tg = _pair(mol, par, cutoff=9.0)
    pos = np.stack([_pos(mol, seed=2), _pos(mol, seed=3)])
    jf = JaxForces(par, terms=ALL_TERMS, precision="double", cutoff=9.0,
                   external=JaxExternal(jg.energy_fn, energy_forces_fn=jg.energy_forces_fn))
    tf = Forces(par, terms=ALL_TERMS, precision="double", cutoff=9.0, kernel=kernel,
                device="cpu", external=tg)
    jfrc, tfrc = np.zeros_like(pos), np.zeros_like(pos)
    want = jf.compute(pos, None, jfrc, returnDetails=True)
    got = tf.compute(pos, None, tfrc, returnDetails=True)
    for w, g in zip(want, got):
        assert set(w) == set(g)
        for k in w:
            _close(g[k], w[k])
    _close(tfrc, jfrc)


@pytest.mark.gpu
def test_gb_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mol, par = _ligand()
    g_cpu = tgb.make_gbsa(par, mol, cutoff=9.0, device="cpu")
    g_gpu = tgb.make_gbsa(par, mol, cutoff=9.0, device="cuda")
    pos = _pos(mol, seed=4)
    e64, f64 = g_cpu.energy_forces_fn(torch.as_tensor(pos))
    e32, f32 = g_gpu.energy_forces_fn(torch.as_tensor(pos, dtype=torch.float32, device="cuda"))
    assert abs(float(e32) - float(e64)) <= 1e-5 * max(1.0, abs(float(e64)))
    assert float((f32.double().cpu() - f64).abs().max()) <= 1e-4 * float(f64.abs().max())
