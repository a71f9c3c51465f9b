"""Per-stage roofline of the dense pair kernel on the card.

Port of scripts/bench_roofline.py: runs the staged probe kernels of
`ops.roofline` (the dense pair computation cut after load / d2 / rsqrt /
math / g / forces, and forces through the row-sum identity, mxred) on the
probe's inputs, times each with CUDA events (`device_ms`), and prints one
JSON line per stage, the mxred-vs-forces errors, the stage deltas (what
each stage adds) and the four elemental throughputs of dependent chains
(fma, rsqrt, exp, div) in tera-operations per second. The errors are
bench_roofline.py's (the largest force difference over the largest force)
and, on the inputs without pairs nearer than 2 A, the largest force
difference of a row over its `force_scale`. Where the toolkit has
cuobjdump, it also prints each stage's pair loop read from the built
kernels (instructions, MUFU and HMMA per pair) and its dense floor: npad^2
pairs times the loop's instructions per pair over the card's issue rate
(ISSUE_PER_S, one instruction a lane a clock), or times its MUFU
operations over the MUFU rate, whichever is longer. Needs a CUDA device.

Usage: python -m torchmd_tpu_torch.roofline [--n 4676] [--tile 512]
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

from .ops import roofline as rl

SLEEP_CYCLES = 40_000_000       # ~20 ms of device sleep before each timed call
CHAIN_SHAPE = (1024, 512)       # elements of the throughput chains
CHAIN_ITERS = 200               # x UNROLL dependent steps per element
# H100 SXM: 67e12 FP32 FLOP/s is 132 SMs x 128 lanes x 2 (an FMA) x 1.98 GHz,
# so 33.5e12 instructions a second issue across the lanes; the SFU does 16
# lanes a clock per SM, an eighth of that
ISSUE_PER_S = 67e12 / 2
MUFU_PER_S = ISSUE_PER_S / 8


def device_ms(fn, calls=30, warmup=3):
    """Median device milliseconds of `fn()` over `calls` calls, each
    bracketed by CUDA events. A sleep kernel before each call lets the
    host queue the whole call while the device waits, so the events time
    the device work and not the Python between launches (one call at a
    time: the launch queue is too short to hold 30 calls of the plain
    versions' hundreds of kernels)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def elemental_throughputs(calls=5):
    """{op: tera-operations/s} of the dependent-chain kernels."""
    x = torch.full(CHAIN_SHAPE, 0.4999, dtype=torch.float32, device="cuda")
    ops = rl.UNROLL * CHAIN_ITERS * x.numel()
    return {op: ops / (device_ms(lambda: rl.chain_call(op, x, CHAIN_ITERS), calls, 1) * 1e-3)
            / 1e12 for op in rl.CHAIN_OPS}


def dense_floors(npad, loops):
    """{stage: ms} of `sass_loop_counts()`'s per-pair counts over npad^2
    pairs: the longer of issue and MUFU time."""
    return {st: 1e3 * npad * npad * max(c["issued"] / ISSUE_PER_S, c["mufu"] / MUFU_PER_S)
            for st, c in loops.items() if c["issued"] is not None}


def run(n=4676, tile=512, calls=30, echo=print):
    """Time every stage and the chains; returns {"ms": {stage: ms},
    "deltas_ms", "mxred_vs_forces_rel_err", "mxred_vs_forces_row_err",
    "elemental_tops", "loops" (`sass_loop_counts()`, None without
    cuobjdump), "dense_floor_ms", "outputs": {stage: (fx, fy, fz,
    energy)}}."""
    if not torch.cuda.is_available():
        raise SystemExit("torchmd_tpu_torch.roofline: no CUDA device")
    inp = rl.make_inputs(n, tile, "cuda")
    res, outs = {}, {}
    for st in rl.STAGES:
        res[st] = device_ms(lambda: rl.stage_call(st, inp), calls)
        outs[st] = rl.stage_call(st, inp)
        echo(json.dumps({"stage": st, "ms": res[st]}))
    torch.cuda.synchronize()
    f, m = outs["forces"], outs["mxred"]
    err = max(float((m[k] - f[k]).abs().max()) / max(1.0, float(f[k].abs().max()))
              for k in range(3))
    near = rl.without_close_pairs(inp)
    row_err = rl.row_error(rl.stage_call("mxred", near)[:3], rl.stage_call("forces", near)[:3],
                           rl.force_scale(rl.in_f64(near)))
    echo(json.dumps({"mxred_vs_forces_rel_err": err, "mxred_vs_forces_row_err": row_err}))
    deltas = {
        "overhead_floor": res["load"],
        "displacement_d2": res["d2"] - res["load"],
        "rsqrt": res["rsqrt"] - res["d2"],
        "pair_math": res["math"] - res["rsqrt"],
        "g_block": res["g"] - res["math"],
        "force_reductions": res["forces"] - res["g"],
        "force_reductions_rowsum": res["mxred"] - res["g"],
    }
    echo(json.dumps({"deltas_ms": deltas}))
    tops = elemental_throughputs()
    echo(json.dumps({"elemental_tops": tops}))
    loops = rl.sass_loop_counts()
    floors = {} if loops is None else dense_floors(inp.x.shape[0], loops)
    echo(json.dumps({"pair_loops": loops if loops is not None else "not taken: no cuobjdump",
                     "dense_floor_ms": floors}))
    return {"ms": res, "deltas_ms": deltas, "mxred_vs_forces_rel_err": err,
            "mxred_vs_forces_row_err": row_err, "elemental_tops": tops, "loops": loops,
            "dense_floor_ms": floors, "outputs": outs}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=4676)
    ap.add_argument("--tile", type=int, default=512)
    args = ap.parse_args(argv)
    run(args.n, args.tile)


if __name__ == "__main__":
    main()
