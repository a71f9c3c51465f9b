"""Staged probe of the dense pair kernel: the CUDA stage and chain kernels
(`csrc/roofline.cu`), their plain PyTorch versions, and the wrappers that
pick between them by device.

Counterpart of `scripts/bench_roofline.py` (`stage_kernel` through
`build_call`): on the same inputs (`make_inputs`, numpy seed 0), stage k
of STAGES adds one step of the dense pair computation to stage k - 1 and
returns the energy it accumulates and, from `forces` on, the per-row
forces:

  load    the mask count;
  d2      sum of d^2 over the mask (d^2 = 1 off it);
  rsqrt   sum of 1/r over the mask;
  math    0.5 sum of LJ (switched) + reaction-field Coulomb within the
          cutoff;
  g       math + sum of g = (dE/dr)/r;
  forces  math, and f_i = -sum_j g dx;
  mxred   math, and f_i = -(x_i sum_j g - sum_j g x_j) (no box), in the
          inputs' dtype as on the TPU.

`stage_call(stage, inp)` runs the plain version for CPU inputs and
launches the kernel for CUDA inputs; on CUDA inputs it launches or raises.
The kernel has bench_roofline.py's constants (CONSTANTS) as literals; the
plain version takes others (`consts`), so that a check can be shown to
catch a wrong one. `chain_call(op, x, iters)` runs UNROLL x iters
dependent steps of one elemental operation (CHAIN_OPS) on every element
of x, the probe's throughput chains.

The kernel's mxred takes its force sums on the tensor cores, g and the
coordinates split into TF32 hi + lo parts. `mxred_tf32_reference(inp,
products)` is the plain emulation of that split (`tf32_round`), the
products summed in f64, for the tests; `sass_loop_counts()` reads the
built kernels' pair loops from `cuobjdump -sass` for their dense floors.

The random inputs put a few pairs a fraction of an angstrom apart, whose
forces outweigh the rest by ~1e15; so results are held row by row, each
force to `force_scale` (sum_j |g| r of its row), and also on
`without_close_pairs(inp)`, where every term has an ordinary size.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
from typing import NamedTuple

import numpy as np
import torch

from . import _build

# Kernel launches made by `stage_call` and by `chain_call` on CUDA.
LAUNCHES = 0
CHAIN_LAUNCHES = 0

STAGES = ("load", "d2", "rsqrt", "math", "g", "forces", "mxred")
CHAIN_OPS = ("fma", "rsqrt", "exp", "div")
UNROLL = 64               # csrc/roofline.cu: chain steps per iteration
UNIT = 128                # csrc/roofline.cu: j columns of a work unit (JC)
PAIRS_PER_LOOP = 8        # csrc/roofline.cu: pairs a thread computes per pair-loop pass
# mxred's products, (part of g, part of the coordinates) in the order
# `mxred_tf32_reference` takes them
TF32_PRODUCTS = (("hi", "hi"), ("hi", "lo"), ("lo", "hi"), ("lo", "lo"))
ELEC = 332.0637
REFERENCE_ROWS = 512      # row block of the plain version (bounds memory)
CLOSE_PAIR = 2.0          # A: `without_close_pairs` drops pairs nearer than this


class Constants(NamedTuple):
    cutoff: float
    switch: float
    krf: float            # reaction field: q_i q_j (1/r + krf r^2 - crf)
    crf: float


CONSTANTS = Constants(cutoff=7.3, switch=6.0, krf=0.0005, crf=0.2)  # bench_roofline.py's


class ProbeInputs(NamedTuple):
    x: torch.Tensor       # (npad,) rows, zero past n
    y: torch.Tensor
    z: torch.Tensor
    q: torch.Tensor
    s: torch.Tensor       # sigma (mixed as s_i + s_j)
    e: torch.Tensor       # epsilon (mixed as e_i * e_j)
    mask: torch.Tensor    # (npad, npad) int8: 1 off the diagonal among the n atoms
    n: int
    tile: int


def make_inputs(n=4676, tile=512, device="cpu", dtype=torch.float32) -> ProbeInputs:
    """bench_roofline.build_call's inputs: n atoms in a 60 A cube with
    charges, sigmas and epsilons from numpy's RandomState(0), padded to a
    multiple of `tile`."""
    npad = -(-n // tile) * tile
    rs = np.random.RandomState(0)
    pos = rs.rand(n, 3).astype(np.float32) * 60.0
    q = rs.randn(n).astype(np.float32) * 0.3
    sg = 1.5 + rs.rand(n).astype(np.float32)
    ep = 0.3 * rs.rand(n).astype(np.float32)

    def row(a):
        return torch.as_tensor(np.pad(a, (0, npad - n)), device=device).to(dtype)

    mask = np.ones((npad, npad), np.int8)
    mask[n:, :] = 0
    mask[:, n:] = 0
    np.fill_diagonal(mask, 0)
    return ProbeInputs(row(pos[:, 0]), row(pos[:, 1]), row(pos[:, 2]), row(q), row(sg),
                       row(ep), torch.as_tensor(mask, device=device), n, tile)


def in_f64(inp: ProbeInputs) -> ProbeInputs:
    """`inp` with its rows in f64 (for the plain reference)."""
    return inp._replace(**{k: getattr(inp, k).double() for k in "xyzqse"})


# ----------------------------------------------------------------------
# Plain PyTorch version
# ----------------------------------------------------------------------

def without_close_pairs(inp: ProbeInputs, rmin=CLOSE_PAIR) -> ProbeInputs:
    """`inp` with the mask cleared for every pair nearer than rmin (in
    f64 from the rows)."""
    pos = torch.stack([inp.x, inp.y, inp.z], 1).double()
    far = torch.cdist(pos, pos, compute_mode="donot_use_mm_for_euclid_dist") >= rmin
    return inp._replace(mask=torch.where(far, inp.mask, torch.zeros_like(inp.mask)))


def _pair_block(inp: ProbeInputs, rows, consts: Constants):
    """The math stage's pair terms of rows `rows` against every row: the
    displacements, the masked d^2 (1 off the mask), the energy terms
    0.5 (LJ + reaction field) inside the cutoff, and g = (dE/dr)/r."""
    x, y, z, q, s, e = inp.x, inp.y, inp.z, inp.q, inp.s, inp.e
    dt = x.dtype
    m = inp.mask[rows] != 0
    dx = x[rows, None] - x[None, :]
    dy = y[rows, None] - y[None, :]
    dz = z[rows, None] - z[None, :]
    d2 = torch.where(m, dx * dx + dy * dy + dz * dz, torch.ones_like(dx))
    rinv = torch.rsqrt(d2)
    fm2 = (m & (d2 <= torch.tensor(consts.cutoff * consts.cutoff, dtype=dt))).to(dt)
    dist = d2 * rinv
    sig = s[rows, None] + s[None, :]
    eps = e[rows, None] * e[None, :]
    s6 = (sig * sig) ** 3
    B = 4.0 * eps * s6
    A = B * s6
    rinv2 = rinv * rinv
    rinv6 = rinv2 * rinv2 * rinv2
    rinv12 = rinv6 * rinv6
    pot = A * rinv12 - B * rinv6
    dEdr = (-12.0 * A * rinv12 + 6.0 * B * rinv6) * rinv
    width = consts.cutoff - consts.switch
    t = (dist - consts.switch) / width
    sw = 1.0 + t * t * t * (-10.0 + t * (15.0 - t * 6.0))
    dsw = t * t * (-30.0 + t * (60.0 - t * 30.0)) / width
    in_sw = dist > consts.switch
    dEdr = torch.where(in_sw, dEdr * sw + pot * dsw, dEdr)
    pot = torch.where(in_sw, pot * sw, pot)
    qq = ELEC * q[rows, None] * q[None, :]
    pot_el = qq * (rinv + consts.krf * d2 - consts.crf)
    dEdr_el = qq * (2.0 * consts.krf - rinv * rinv * rinv)
    g = (dEdr * rinv + dEdr_el) * fm2
    return dx, dy, dz, d2, 0.5 * (pot + pot_el) * fm2, g


def stage_reference(stage, inp: ProbeInputs, consts: Constants = CONSTANTS):
    """Plain version of one stage at the dtype and on the device of the
    inputs, in row blocks. Returns (fx, fy, fz, energy)."""
    k = STAGES.index(stage)
    x, y, z = inp.x, inp.y, inp.z
    dt, npad = x.dtype, x.shape[0]
    f = torch.zeros((3, npad), dtype=dt, device=x.device)
    energy = torch.zeros((), dtype=dt, device=x.device)
    for r0 in range(0, npad, REFERENCE_ROWS):
        rows = slice(r0, r0 + REFERENCE_ROWS)
        m = inp.mask[rows] != 0
        fm = m.to(dt)
        if k == 0:
            energy = energy + fm.sum()
            continue
        if k < 3:
            dx = x[rows, None] - x[None, :]
            dy = y[rows, None] - y[None, :]
            dz = z[rows, None] - z[None, :]
            d2 = torch.where(m, dx * dx + dy * dy + dz * dz, torch.ones_like(dx))
            energy = energy + ((d2 if k == 1 else torch.rsqrt(d2)) * fm).sum()
            continue
        dx, dy, dz, _, pot, g = _pair_block(inp, rows, consts)
        energy = energy + pot.sum()
        if k == 4:
            energy = energy + g.sum()
        elif k == 5:
            f[:, rows] = -torch.stack([(g * dx).sum(1), (g * dy).sum(1), (g * dz).sum(1)])
        elif k == 6:
            srow = g.sum(1)
            gr = g @ torch.stack([x, y, z], 1)
            ri = torch.stack([x[rows], y[rows], z[rows]])
            f[:, rows] = gr.T - ri * srow
    return f[0], f[1], f[2], energy


def force_scale(inp: ProbeInputs, consts: Constants = CONSTANTS):
    """(npad,) sum_j |g_ij| r_ij, at the dtype of the inputs: the size of
    the terms that make up each row's force, the scale a row's force
    error is held to."""
    out = torch.zeros_like(inp.x)
    for r0 in range(0, inp.x.shape[0], REFERENCE_ROWS):
        rows = slice(r0, r0 + REFERENCE_ROWS)
        _, _, _, d2, _, g = _pair_block(inp, rows, consts)
        out[rows] = (g.abs() * d2.sqrt()).sum(1)
    return out


def row_error(got, want, scale):
    """max over rows of max_k |got_k - want_k| / max(1, scale): forces
    (fx, fy, fz) held row by row to `force_scale`."""
    d = torch.stack([a.double() - b.double() for a, b in zip(got, want)]).abs().amax(0)
    return float((d / scale.double().clamp(min=1.0)).max())


def tf32_round(x):
    """f32 tensor x rounded to TF32 (10 mantissa bits), to nearest with
    ties away from zero, on its bit pattern (cvt.rna.tf32.f32)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def mxred_tf32_reference(inp: ProbeInputs, products=3):
    """Plain emulation of mxred on the tensor cores (f32 inputs): g (at
    f32) and B = (x_j, y_j, z_j, 1) split into TF32 hi + lo, the first
    `products` of TF32_PRODUCTS summed in f64 (only the operands'
    rounding), f_i = sum_j g B_j[:3] - r_i sum_j g. Used only by tests.
    Returns (fx, fy, fz, energy) in f64."""
    x, y, z = inp.x, inp.y, inp.z
    npad = x.shape[0]
    b = torch.stack([x, y, z, torch.ones_like(x)], 1)
    b_hi = tf32_round(b)
    parts_b = {"hi": b_hi.double(), "lo": tf32_round(b - b_hi).double()}
    f = torch.zeros((3, npad), dtype=torch.float64)
    energy = torch.zeros((), dtype=torch.float64)
    for r0 in range(0, npad, REFERENCE_ROWS):
        rows = slice(r0, r0 + REFERENCE_ROWS)
        _, _, _, _, pot, g = _pair_block(inp, rows, CONSTANTS)
        g_hi = tf32_round(g)
        parts_g = {"hi": g_hi.double(), "lo": tf32_round(g - g_hi).double()}
        gr = sum(parts_g[a] @ parts_b[c] for a, c in TF32_PRODUCTS[:products])
        ri = torch.stack([x[rows], y[rows], z[rows]]).double()
        f[:, rows] = gr[:, :3].T - ri * gr[:, 3]
        energy = energy + pot.double().sum()
    return f[0], f[1], f[2], energy


def chain_reference(op, x, iters):
    """Plain version of the chain kernel: UNROLL x iters steps of `op` on
    a copy of x."""
    c = x.clone()
    for _ in range(iters * UNROLL):
        if op == "fma":
            c = c * c + 0.25
        elif op == "rsqrt":
            c = torch.rsqrt(c + 1.0)
        elif op == "exp":
            c = torch.exp(-c) + 0.1
        else:
            c = 1.0 / (c + 1.0)
    return c


# ----------------------------------------------------------------------
# CUDA kernels
# ----------------------------------------------------------------------

_P = ctypes.c_void_p
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("roofline")
        lib.tmd_roofline_stage.argtypes = ([ctypes.c_int] + [_P] * 7
                                           + [ctypes.c_int] * 2 + [_P] * 8)
        lib.tmd_roofline_stage.restype = ctypes.c_int
        lib.tmd_roofline_scratch_bytes.argtypes = [ctypes.c_int]
        lib.tmd_roofline_scratch_bytes.restype = ctypes.c_longlong
        lib.tmd_roofline_chain.argtypes = [ctypes.c_int, _P, ctypes.c_int, ctypes.c_int, _P]
        lib.tmd_roofline_chain.restype = ctypes.c_int
        lib.tmd_error_string.argtypes = [ctypes.c_int]
        lib.tmd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def build():
    """Compile and load the kernel library (done at first launch anyway)."""
    _library()


def _check(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {lib.tmd_error_string(err).decode()}")


def _launch(stage, inp: ProbeInputs):
    global LAUNCHES
    dev, npad, tile = inp.x.device, inp.x.shape[0], inp.tile
    if tile % UNIT or tile > 1024 or npad % tile:
        raise ValueError(f"tile {tile} must be a multiple of {UNIT} up to 1024 "
                         f"dividing npad {npad}")
    for name in ("x", "y", "z", "q", "s", "e"):
        _build.check_tensor(getattr(inp, name), name, torch.float32, (npad,), dev)
    _build.check_tensor(inp.mask, "mask", torch.int8, (npad, npad), dev)
    if inp.mask.data_ptr() % 16:
        raise ValueError("mask must start on a 16-byte boundary (the kernel copies "
                         "16-byte pieces)")
    lib = _library()
    scratch = torch.empty(lib.tmd_roofline_scratch_bytes(npad), dtype=torch.uint8, device=dev)
    f = torch.empty((3, npad), dtype=torch.float32, device=dev)
    acc = torch.empty(1, dtype=torch.float64, device=dev)
    ticket = torch.empty(1, dtype=torch.int32, device=dev)
    out = torch.empty(1, dtype=torch.float32, device=dev)
    _check(lib, lib.tmd_roofline_stage(
        STAGES.index(stage), inp.x.data_ptr(), inp.y.data_ptr(), inp.z.data_ptr(),
        inp.q.data_ptr(), inp.s.data_ptr(), inp.e.data_ptr(), inp.mask.data_ptr(), npad,
        tile, scratch.data_ptr(), f[0].data_ptr(), f[1].data_ptr(), f[2].data_ptr(),
        acc.data_ptr(), ticket.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream), "roofline stage")
    LAUNCHES += 1
    return f[0], f[1], f[2], out[0]


def stage_call(stage, inp: ProbeInputs):
    """One stage on `inp`: (fx, fy, fz, energy). CPU inputs run the plain
    version; CUDA inputs launch the kernel (f32 only) or raise."""
    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r}; one of {STAGES}")
    if inp.x.device.type == "cuda":
        return _launch(stage, inp)
    if inp.x.device.type == "cpu":
        return stage_reference(stage, inp)
    raise ValueError(f"no roofline kernel for device {inp.x.device}")


def chain_call(op, x, iters):
    """UNROLL x iters dependent steps of `op` on every element of x (f32):
    on a CUDA tensor the chain kernel, in place, returning x; on a CPU
    tensor the plain version."""
    global CHAIN_LAUNCHES
    if op not in CHAIN_OPS:
        raise ValueError(f"unknown op {op!r}; one of {CHAIN_OPS}")
    if x.device.type == "cpu":
        return chain_reference(op, x, iters)
    if x.device.type != "cuda":
        raise ValueError(f"no chain kernel for device {x.device}")
    _build.check_tensor(x, "x", torch.float32, tuple(x.shape), x.device)
    lib = _library()
    _check(lib, lib.tmd_roofline_chain(CHAIN_OPS.index(op), x.data_ptr(), x.numel(),
                                       int(iters),
                                       torch.cuda.current_stream(x.device).cuda_stream),
           "chain")
    CHAIN_LAUNCHES += 1
    return x


# ----------------------------------------------------------------------
# The built kernels' pair loops (cuobjdump -sass)
# ----------------------------------------------------------------------

_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def _cuobjdump():
    for cand in (shutil.which("cuobjdump"), os.path.join(os.path.dirname(_build.CUDA_NVCC),
                                                         "cuobjdump")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    return None


def _pair_loop(instrs):
    """The largest innermost loop of one function's (address, opcode,
    operands) list: the instructions between a backward BRA's target and
    the BRA, for the BRA whose span holds no other backward branch."""
    edges = []
    for addr, op, args in instrs:
        m = re.search(r"0x([0-9a-f]+)", args)
        if op.startswith("BRA") and m and int(m.group(1), 16) <= addr:
            edges.append((int(m.group(1), 16), addr))
    inner = [(t, s) for t, s in edges
             if not any(t <= t2 and s2 <= s and (t2, s2) != (t, s) for t2, s2 in edges)]
    if not inner:
        return []
    t, s = max(inner, key=lambda e: e[1] - e[0])
    return [op for addr, op, _ in instrs if t <= addr <= s and not op.startswith("NOP")]


def sass_loop_counts():
    """{stage: {"issued", "fp32", "mufu", "hmma" per pair, "hmma_in_kernel"}}
    of each built stage kernel, read from `cuobjdump -sass` of the library:
    its pair loop's instructions (every one an issue slot; fp32 the F*
    arithmetic among them; MUFU; HMMA) over the PAIRS_PER_LOOP pairs a
    thread computes in one pass, and the HMMA instructions of the whole
    kernel. None where the toolkit has no cuobjdump. Builds the library."""
    tool = _cuobjdump()
    if tool is None:
        return None
    text = subprocess.run([tool, "-sass", _build.build("roofline")], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for block in re.split(r"\n\s*Function : ", text)[1:]:
        name = _build._kernel_name(block.split(None, 1)[0])
        m = re.fullmatch(r"stage_kernel<(\d)>", name)
        if not m:
            continue
        instrs = [(int(a, 16), op, args) for a, op, args in _SASS_LINE.findall(block)]
        loop = _pair_loop(instrs)
        per_pair = {k: sum(map(f, loop)) / PAIRS_PER_LOOP if loop else None for k, f in (
            ("issued", lambda op: True),
            ("fp32", lambda op: op.startswith("F") and not op.startswith("F2")),
            ("mufu", lambda op: op.startswith("MUFU")),
            ("hmma", lambda op: op.startswith("HMMA")))}
        out[STAGES[int(m.group(1))]] = dict(
            per_pair, loop_instructions=len(loop),
            hmma_in_kernel=sum(op.startswith("HMMA") for _, op, _ in instrs))
    return out
