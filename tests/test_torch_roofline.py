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
  - the kernel's mxred, emulated with g and the coordinates split into
    TF32 hi + lo (`mxred_tf32_reference`, products summed in f64), stays
    within that bar with three products and misses it with one (a
    planted control);
  - the pair loop is read from a SASS listing as the kernel's floors
    need it;
  - the chain kernels' plain versions take UNROLL dependent steps.
The kernels themselves run on the card (marked gpu; chip_smoke.py holds
them to the plain versions at the full 4,676 atoms).
"""

from __future__ import annotations

import functools
import importlib.util
import os
import types

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


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-11 - 2**-20, -(1.0 + 3 * 2**-11), 0.0])
    want = [1.0, 1.0 + 2**-10, 1.0, -(1.0 + 2**-9), 0.0]
    assert rl.tf32_round(x).tolist() == want
    bits = rl.tf32_round(torch.randn(1000, generator=torch.Generator().manual_seed(0)))
    assert int((bits.view(torch.int32) & 0x1FFF).abs().sum()) == 0


@pytest.mark.parametrize("products,within", [(3, True), (1, False)],
                         ids=["three_products", "one_product_control"])
def test_mxred_tf32_emulation_against_the_forces(products, within):
    inp = _inputs("no_close_pairs")
    m = rl.mxred_tf32_reference(inp, products)
    f = rl.stage_call("forces", inp)
    err = rl.row_error(m[:3], f[:3], _scale("no_close_pairs"))
    assert (err <= REL) == within, err
    assert abs(float(m[3]) - float(f[3])) <= REL * max(1.0, abs(float(f[3])))


SASS = """
\t\tFunction : _ZN12_GLOBAL__N_112stage_kernelILi6EEEvPK6float4
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   FFMA R2, R3, R4, R5 ;
        /*0020*/                   HMMA.1688.F32.TF32 R8, R12, R16, R8 ;
        /*0030*/                   FADD R2, R3, R4 ;
        /*0040*/                   MUFU.RSQ R5, R6 ;
        /*0050*/                   FFMA R2, R3, R4, R5 ;
        /*0060*/                   HMMA.1688.F32.TF32 R8, R12, R16, R8 ;
        /*0070*/                   NOP ;
        /*0080*/               @P0 BRA 0x30 ;
        /*0090*/                   LDS.128 R4, [R2] ;
        /*00a0*/              @!P1 BRA 0x90 ;
        /*00b0*/                   BRA 0xb0;
        /*00c0*/                   EXIT ;
\t\tFunction : _ZN12_GLOBAL__N_112chain_kernelILi0EEEvPfii
        /*0000*/                   FFMA R2, R3, R4, R5 ;
"""


def test_sass_pair_loop_from_listing(monkeypatch):
    monkeypatch.setattr(rl, "_cuobjdump", lambda: "cuobjdump")
    monkeypatch.setattr(rl._build, "build", lambda name: "lib.so")
    monkeypatch.setattr(rl.subprocess, "run",
                        lambda *a, **k: types.SimpleNamespace(stdout=SASS))
    counts = rl.sass_loop_counts()
    # the loop 0x30-0x80 (the self-loop at 0xb0 is not the largest, 0x90-0xa0
    # is smaller): FADD, MUFU, FFMA, HMMA, BRA; the NOP is not issued
    assert list(counts) == ["mxred"]
    c = counts["mxred"]
    n = rl.PAIRS_PER_LOOP
    assert c["loop_instructions"] == 5
    assert (c["issued"], c["fp32"], c["mufu"], c["hmma"]) == (5 / n, 2 / n, 1 / n, 1 / n)
    assert c["hmma_in_kernel"] == 2


def test_dense_floor_is_the_longer_of_issue_and_mufu():
    loops = {"forces": {"issued": 70.0, "mufu": 1.0}, "chain": {"issued": 4.0, "mufu": 1.0},
             "unread": {"issued": None, "mufu": None}}
    floors = probe_run.dense_floors(5120, loops)
    assert set(floors) == {"forces", "chain"}
    pairs = 5120 * 5120
    assert floors["forces"] == pytest.approx(1e3 * pairs * 70.0 / probe_run.ISSUE_PER_S)
    assert floors["chain"] == pytest.approx(1e3 * pairs * 1.0 / probe_run.MUFU_PER_S)


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
def test_mxred_kernel_matches_tf32_emulation():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    inp = rl.without_close_pairs(rl.make_inputs(N, TILE, "cuda"))
    got = rl.stage_call("mxred", inp)
    cpu = rl.ProbeInputs(*(t.cpu() if torch.is_tensor(t) else t for t in inp))
    want = rl.mxred_tf32_reference(cpu, 3)
    scale = rl.force_scale(rl.in_f64(cpu))
    assert rl.row_error([t.cpu() for t in got[:3]], want[:3], scale) <= REL


@pytest.mark.gpu
@pytest.mark.parametrize("op", rl.CHAIN_OPS)
def test_chain_kernel_on_cuda_matches_plain(op):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    x = torch.full(probe_run.CHAIN_SHAPE, 0.4999, device="cuda")
    want = rl.chain_reference(op, x, probe_run.CHAIN_ITERS)
    got = rl.chain_call(op, x.clone(), probe_run.CHAIN_ITERS)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
