"""The port's staged pair-kernel probe (`ops.roofline`) against the JAX
probe `scripts/bench_roofline.py`.

For every stage, `build_call(stage, 300, 128)` (300 atoms padded to 384,
tiles of 128) runs the Pallas `stage_kernel` in interpret mode on the CPU
(`pl.pallas_call` patched to interpret=True inside the tests only), and
the port's plain version runs on the same inputs, which `make_inputs`
rebuilds from numpy's RandomState(0) element for element. The random
rows put a few pairs a fraction of an angstrom apart, whose forces
outweigh the rest by many decades, so:

  - energies agree within 1e-5 relative, and each row's force within
    1e-5 of max(1, its `force_scale`, the sum of |g| r over its pairs, in
    f64): both sides sum f32 terms in different orders;
  - the same holds on the same rows with the pairs nearer than 2 A taken
    out of the mask (`without_close_pairs`), where every term has an
    ordinary size and the energy-only stages see the reaction field and
    the switch;
  - planted faults in the port's plain version (k_rf doubled, the
    switch moved) fail those checks;
  - `mxred` gives the `forces` stage's forces within 1e-5 of each row's
    scale without the close pairs;
  - the chain kernels' plain versions take UNROLL dependent steps.
The kernels themselves run on the card (marked gpu; chip_smoke.py holds
them to the plain versions at the full 4,676 atoms).
"""

from __future__ import annotations

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmd_tpu_torch import roofline as probe_run
from torchmd_tpu_torch.ops import roofline as rl

torch.set_num_threads(1)

N, TILE = 300, 128
REL = 1e-5
SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "scripts", "bench_roofline.py")
INPUTS = ("probe", "no_close_pairs")


@pytest.fixture(scope="module")
def probe():
    """scripts/bench_roofline.py as a module (it sets a default JAX cache
    directory on import, after jax is configured: no effect here)."""
    spec = importlib.util.spec_from_file_location("bench_roofline_probe", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    saved = dict(os.environ)
    try:
        spec.loader.exec_module(mod)
    finally:
        os.environ.clear()
        os.environ.update(saved)
    return mod


@pytest.fixture
def interpret(monkeypatch, probe):
    monkeypatch.setattr(probe.pl, "pallas_call",
                        functools.partial(probe.pl.pallas_call, interpret=True))
    return probe


@functools.lru_cache(maxsize=None)
def _inputs(which):
    inp = rl.make_inputs(N, TILE)
    return inp if which == "probe" else rl.without_close_pairs(inp)


@functools.lru_cache(maxsize=None)
def _scale(which):
    return rl.force_scale(rl.in_f64(_inputs(which)))


_JAX = {}


def _jax_stage(probe, stage, which="probe"):
    """The Pallas stage kernel (interpret mode) on `which` inputs: (forces
    as three f64 arrays, energy); the mask of `without_close_pairs` goes
    in as the kernel's mask input."""
    if (stage, which) not in _JAX:
        call, args = probe.build_call(stage, N, TILE)
        if which != "probe":
            args = args[:12] + (jnp.asarray(_inputs(which).mask.numpy()),)
        fx, fy, fz, e = jax.jit(call)(*args)
        _JAX[stage, which] = ([np.asarray(a, np.float64).reshape(-1) for a in (fx, fy, fz)],
                              float(e[0, 0]))
    return _JAX[stage, which]


def _ratios(got, f_jax, e_jax, which):
    """(energy error, largest row force error) over their bars."""
    e_r = abs(float(got[3]) - e_jax) / (REL * max(1.0, abs(e_jax)))
    f_r = rl.row_error(got[:3], [torch.from_numpy(f) for f in f_jax], _scale(which)) / REL
    return e_r, f_r


def test_inputs_equal_build_call(probe):
    _, args = probe.build_call("load", N, TILE)
    inp = rl.make_inputs(N, TILE)
    for got, want in zip((inp.x, inp.y, inp.z, inp.q, inp.s, inp.e),
                         args[:6]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want)[0])
    np.testing.assert_array_equal(inp.mask.numpy(), np.asarray(args[12]))


def test_without_close_pairs_clears_only_close_pairs():
    inp, near = _inputs("probe"), _inputs("no_close_pairs")
    pos = torch.stack([inp.x, inp.y, inp.z], 1).double()
    r = torch.cdist(pos, pos, compute_mode="donot_use_mm_for_euclid_dist")
    m0, m1 = inp.mask != 0, near.mask != 0
    assert bool((m1 == (m0 & (r >= rl.CLOSE_PAIR))).all())
    assert int((m0 & ~m1).sum()) > 0      # the probe's rows have close pairs


@pytest.mark.parametrize("stage", rl.STAGES)
def test_plain_stage_matches_pallas_interpret(interpret, stage):
    f_jax, e_jax = _jax_stage(interpret, stage)
    e_r, f_r = _ratios(rl.stage_call(stage, _inputs("probe")), f_jax, e_jax, "probe")
    assert e_r <= 1.0 and f_r <= 1.0, (e_r, f_r)


@pytest.mark.parametrize("stage", rl.STAGES)
def test_plain_stage_without_close_pairs_matches_pallas_interpret(interpret, stage):
    f_jax, e_jax = _jax_stage(interpret, stage, "no_close_pairs")
    e_r, f_r = _ratios(rl.stage_call(stage, _inputs("no_close_pairs")), f_jax, e_jax,
                       "no_close_pairs")
    assert e_r <= 1.0 and f_r <= 1.0, (e_r, f_r)


C = rl.CONSTANTS


@pytest.mark.parametrize("stage,which,wrong", [
    ("forces", "probe", C._replace(krf=2 * C.krf)),
    ("forces", "probe", C._replace(switch=6.1)),
    ("math", "no_close_pairs", C._replace(krf=2 * C.krf)),
    ("g", "no_close_pairs", C._replace(krf=2 * C.krf)),
    ("math", "no_close_pairs", C._replace(crf=0.0)),
], ids=["forces-krf_x2", "forces-switch_6.1", "math-krf_x2", "g-krf_x2", "math-crf_0"])
def test_planted_fault_fails_the_check(interpret, stage, which, wrong):
    f_jax, e_jax = _jax_stage(interpret, stage, which)
    e_r, f_r = _ratios(rl.stage_reference(stage, _inputs(which), wrong), f_jax, e_jax, which)
    assert max(e_r, f_r) > 1.0, (e_r, f_r)


@pytest.mark.parametrize("which", INPUTS)
def test_mxred_gives_the_forces(which):
    inp = _inputs(which)
    f = rl.stage_call("forces", inp)
    m = rl.stage_call("mxred", inp)
    assert float(m[3]) == float(f[3])
    assert rl.row_error(m[:3], f[:3], _scale(which)) <= REL


def test_force_scale_bounds_the_forces():
    inp = rl.in_f64(_inputs("probe"))
    f = torch.stack(rl.stage_call("forces", inp)[:3])
    assert bool((f.abs() <= _scale("probe").double() * (1 + 1e-12)).all())


@pytest.mark.parametrize("op", rl.CHAIN_OPS)
def test_chain_reference_steps(op):
    x = torch.full((4,), 0.4999)
    step = {"fma": lambda c: c * c + 0.25, "rsqrt": lambda c: 1.0 / np.sqrt(c + 1.0),
            "exp": lambda c: np.exp(-c) + 0.1, "div": lambda c: 1.0 / (c + 1.0)}[op]
    c = 0.4999
    for _ in range(rl.UNROLL):
        c = step(c)
    np.testing.assert_allclose(rl.chain_call(op, x, 1).numpy(), c, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("which", INPUTS)
@pytest.mark.parametrize("stage", rl.STAGES)
def test_stage_kernel_on_cuda_matches_plain(stage, which):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    inp = rl.make_inputs(N, TILE, "cuda")
    if which != "probe":
        inp = rl.without_close_pairs(inp)
    n0 = rl.LAUNCHES
    got = rl.stage_call(stage, inp)
    assert rl.LAUNCHES == n0 + 1
    ref = rl.stage_reference(stage, rl.in_f64(inp))
    assert abs(float(got[3]) - float(ref[3])) <= 2e-5 * max(1.0, abs(float(ref[3])))
    assert rl.row_error(got[:3], ref[:3], rl.force_scale(rl.in_f64(inp))) <= 5e-5


@pytest.mark.gpu
@pytest.mark.parametrize("op", rl.CHAIN_OPS)
def test_chain_kernel_on_cuda_matches_plain(op):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    x = torch.full(probe_run.CHAIN_SHAPE, 0.4999, device="cuda")
    want = rl.chain_reference(op, x, probe_run.CHAIN_ITERS)
    got = rl.chain_call(op, x.clone(), probe_run.CHAIN_ITERS)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
