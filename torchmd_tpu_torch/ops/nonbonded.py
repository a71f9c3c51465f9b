"""Dense all-pairs nonbonded energy + forces: the CUDA pair kernel, its
plain PyTorch version, and the wrapper that picks between them by device.

Counterpart of `torchmd_tpu/ops/pallas_nonbonded.py`. The kernel
(`csrc/nonbonded.cu`) computes the contract of the Pallas kernels
`_kernel_tri` and `_kernel`: lj (Lorentz-Berthelot from per-atom sigma/2
and sqrt|eps| rows, or NBFIX A/B tables, with the polynomial switch), or
repulsion, or repulsioncg, plus Coulomb (plain, reaction field or Ewald
erfc); exclusions from an int8 mask, the cutoff on d^2, and a diagonal
minimum-image wrap where a 0 box component disables that axis. It walks
32-atom tiles in the caller's order, culled by box; the exclusions reach
it as `tile_exclusions` of the mask, made once per topology in
`prepare_nb_data`.

`nonbonded_energy_forces(data, cfg, pos, box)` runs the plain version
for a CPU tensor and launches the kernel for a CUDA tensor; on a CUDA
tensor it launches or raises. A launch takes one LJ-family term: a term
set with several takes one launch per such term (`launch_cfgs`), on
either device. `pos` (R, N, 3) is a replica ladder of one topology, with
a box per replica ((R, 3)) or none: one launch of the kernel for all R
replicas (the plain version loops over them), each replica's result bit
for bit that of a one-replica launch. `rows=(it0, it1)` takes the i tiles
[it0, it1) against all atoms (the spatially sharded path's row block,
`torchmd_tpu/parallel/spatial.py:64-77`): forces of rows
[32 it0, min(N, 32 it1)) and those rows' 0.5-weighted energies; the rows
of a range equal the same rows of the full call bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..units import ELEC_FACTOR

from ..potentials import (LJ_FAMILY, add_energy, nonbonded_block_energy_forces,
                          rfa_constants, wrap_displacement)
from . import _build

# Kernel launches made by `nonbonded_energy_forces` (one per call on CUDA;
# a call is two launches on the card: the prep pass and the walk), and
# those of its row-range form (`rows=`, the spatially sharded path)
LAUNCHES = 0
ROW_LAUNCHES = 0

TILE = 32                 # atoms per tile (csrc/tile_pairs.cuh TILE)
REFERENCE_ROWS = 2048     # row block of the plain version (bounds memory)
# the tile walk's counters (csrc/tile_pairs.cuh Counters), of every pair
# kernel on the walk
STATS = ("candidate_tile_pairs", "tile_pairs", "slot_pairs", "rounds", "lane_rounds")


def make_kernel_cfg(cfg, pbc) -> dict:
    """Kernel-config dict from a ForceTermConfig (same keys and values as
    torchmd_tpu.ops.pallas_nonbonded.make_kernel_cfg)."""
    kcfg = {
        "cutoff": None if cfg.cutoff is None else float(cfg.cutoff),
        "switch": None if cfg.switch_dist is None else float(cfg.switch_dist),
        "rfa": bool(cfg.rfa),
        "lj": "lj" in cfg.terms,
        "elec": "electrostatics" in cfg.terms,
        "repulsion": "repulsion" in cfg.terms,
        "repulsioncg": "repulsioncg" in cfg.terms,
        "elec_factor": float(ELEC_FACTOR),
        "ewald_alpha": (None if cfg.ewald_alpha is None
                        else float(cfg.ewald_alpha)),
        "pbc": bool(pbc),
        "krf": 0.0,
        "crf": 0.0,
        "nbfix": False,
    }
    if kcfg["rfa"] and kcfg["cutoff"]:
        kcfg["krf"], kcfg["crf"] = rfa_constants(cfg)
    return kcfg


def supported_terms(cfg) -> bool:
    """One launch of a pair kernel sums the LJ family into one energy, so
    at most one of lj/repulsion/repulsioncg may be active in it (the
    wrappers split a larger set with `launch_cfgs`)."""
    return sum(t in cfg.terms for t in LJ_FAMILY) <= 1


def launch_cfgs(cfg) -> list:
    """The term sets of the pair kernels' launches for `cfg`: the first
    keeps electrostatics and the first LJ-family term, and each further
    LJ-family term takes a launch of its own with electrostatics off."""
    lj = [t for t in LJ_FAMILY if t in cfg.terms]
    if len(lj) <= 1:
        return [cfg]
    first = tuple(t for t in cfg.terms if t not in lj[1:])
    return [cfg._replace(terms=first)] + [cfg._replace(terms=(t,)) for t in lj[1:]]


def over_launches(cfg, call):
    """`call(c)` -> (energies, forces[, virial]) for each c of
    `launch_cfgs(cfg)`: energies keyed by their own terms, forces and
    virials added."""
    outs = [call(c) for c in launch_cfgs(cfg)]
    if len(outs) == 1:
        return outs[0]
    pot: dict = {}
    for out in outs:
        for k, v in out[0].items():
            add_energy(pot, k, v)
    return (pot,) + tuple(sum(parts[1:], parts[0]) for parts in zip(*(o[1:] for o in outs)))


class NBData(NamedTuple):
    """Per-atom rows, the mask and its tile form, prepared once per
    topology."""

    natoms: int
    q: torch.Tensor                     # (N,) charges
    sig: torch.Tensor                   # (N,) sigma/2
    eps: torch.Tensor                   # (N,) sqrt|epsilon|
    types: torch.Tensor                 # (N,) int32 LJ type
    mask: torch.Tensor                  # (N, N) int8, 1 = interacting pair
    lj_a: Optional[torch.Tensor] = None  # (T, T) NBFIX A table
    lj_b: Optional[torch.Tensor] = None  # (T, T) NBFIX B table
    # `tile_exclusions(mask)`: what the kernel reads of the mask
    excl_start: Optional[torch.Tensor] = None  # (ceil(N/32) + 1,) int32
    excl_tile: Optional[torch.Tensor] = None   # (X,) int32
    excl_bits: Optional[torch.Tensor] = None   # (X, 32) int32


def atom_rows(ffp, dtype=None) -> dict:
    """Per-atom kernel rows from FFParams, on ffp's device, at `dtype`
    (default: the dtype of ffp.charges): natoms, q, sig (sigma/2), eps
    (sqrt|eps|), types (int32) and the NBFIX lj_a/lj_b tables or None."""
    dtype = ffp.charges.dtype if dtype is None else dtype
    n = int(ffp.charges.shape[0])
    dev = ffp.charges.device
    types = ffp.mapped_atom_types
    lj_a = lj_b = None
    if ffp.lj_ab is not None:
        lj_a = ffp.lj_ab[0].to(dtype).contiguous()
        lj_b = ffp.lj_ab[1].to(dtype).contiguous()
        sig = eps = torch.zeros(n, dtype=dtype, device=dev)
    elif ffp.lj_params is not None:
        # rows carry sigma/2 and sqrt|eps|: mixing in the hot loop is one
        # add and one multiply
        sig = (0.5 * ffp.lj_params[:, 0][types]).to(dtype)
        eps = torch.sqrt(torch.abs(ffp.lj_params[:, 1][types])).to(dtype)
    else:
        sig = eps = torch.zeros(n, dtype=dtype, device=dev)
    return dict(natoms=n, q=ffp.charges.to(dtype).contiguous(),
                sig=sig.contiguous(), eps=eps.contiguous(),
                types=types.to(torch.int32).contiguous(), lj_a=lj_a, lj_b=lj_b)


def tile_exclusions(mask):
    """The zeros of the (N, N) mask by 32-atom tile pair, for the kernel:
    (start, tile, bits). Tile pair (I, J) holds a zero when mask[i, j] == 0
    for some i of tile I and j of tile J; for each i tile I, the J of such
    pairs ascend in tile[start[I]:start[I + 1]], and bits[x, r] has bit k
    set when mask[32 I + r, 32 J + k] == 0 (int32, two's complement), for
    J = tile[x]. Exact for any mask, the diagonal included."""
    n = int(mask.shape[0])
    nt = -(-n // TILE)
    pad = nt * TILE
    zero = torch.zeros((pad, pad), dtype=torch.bool, device=mask.device)
    zero[:n, :n] = mask == 0
    blocks = zero.view(nt, TILE, nt, TILE)
    ti, tj = blocks.any(dim=3).any(dim=1).nonzero(as_tuple=True)
    weights = torch.bitwise_left_shift(
        torch.ones(TILE, dtype=torch.int64, device=mask.device),
        torch.arange(TILE, device=mask.device))
    words = (blocks[ti, :, tj, :].to(torch.int64) * weights).sum(-1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    start = torch.zeros(nt + 1, dtype=torch.int64, device=mask.device)
    start.index_add_(0, ti + 1, torch.ones_like(ti))
    return (torch.cumsum(start, 0).to(torch.int32), tj.to(torch.int32).contiguous(),
            words.to(torch.int32).contiguous())


def prepare_nb_data(ffp, dtype=None) -> NBData:
    """Kernel inputs from FFParams, on ffp's device, at `dtype` (default:
    the dtype of ffp.charges)."""
    mask = ffp.nb_mask.to(torch.int8).contiguous()
    start, tile, bits = tile_exclusions(mask)
    return NBData(mask=mask, excl_start=start, excl_tile=tile, excl_bits=bits,
                  **atom_rows(ffp, dtype))


# ----------------------------------------------------------------------
# Plain PyTorch version
# ----------------------------------------------------------------------

def row_span(natoms, tiles):
    """(first row, end row) of the i tiles `tiles` = (it0, it1), or of all
    rows for None; raises on a range outside [0, ceil(N / TILE)]."""
    if tiles is None:
        return 0, natoms
    it0, it1 = (int(t) for t in tiles)
    nt = -(-natoms // TILE)
    if not 0 <= it0 <= it1 <= nt:
        raise ValueError(f"row range {tiles} outside the {nt} tiles of {natoms} atoms")
    lo = min(natoms, it0 * TILE)
    return lo, max(lo, min(natoms, it1 * TILE))


def pair_terms_reference(data: NBData, cfg, pos, box=None, rows=None):
    """Plain PyTorch version of the pair kernel: the port's
    `nonbonded_block_energy_forces` on the kernel's inputs, over the full
    square (or the i tiles `rows` = (it0, it1) against all atoms) in
    blocks of REFERENCE_ROWS rows, at the dtype and on the device of
    `pos`. Returns ({term: energy}, forces (N, 3), or of the range's
    rows)."""
    n, dt = data.natoms, pos.dtype
    lo, hi = row_span(n, rows)
    mask = data.mask != 0
    q, sig, eps = data.q.to(dt), data.sig.to(dt), data.eps.to(dt)
    ti = data.types.long()
    want_lj = any(t in cfg.terms for t in LJ_FAMILY)
    # an empty range has no rows and zero energies
    pot: dict = {t: pos.new_zeros(()) for t in (*LJ_FAMILY, "electrostatics")
                 if t in cfg.terms}
    forces = pos.new_empty((hi - lo, 3))
    for r0 in range(lo, hi, REFERENCE_ROWS):
        rows = slice(r0, min(hi, r0 + REFERENCE_ROWS))
        dv = wrap_displacement(pos[rows, None, :] - pos[None, :, :], box)
        qq = A = B = None
        if "electrostatics" in cfg.terms:
            qq = ELEC_FACTOR * q[rows, None] * q[None, :]
        if want_lj and data.lj_a is not None:
            A = data.lj_a.to(dt)[ti[rows, None], ti[None, :]]
            B = data.lj_b.to(dt)[ti[rows, None], ti[None, :]]
        elif want_lj:
            s6 = (sig[rows, None] + sig[None, :]) ** 6
            B = 4.0 * (eps[rows, None] * eps[None, :]) * s6
            A = B * s6
        block, forces_rows = nonbonded_block_energy_forces(
            cfg, dv, mask[rows], qq, A, B)
        forces[rows.start - lo:rows.stop - lo] = forces_rows
        for k, v in block.items():
            add_energy(pot, k, v)
    return pot, forces


# ----------------------------------------------------------------------
# CUDA kernel
# ----------------------------------------------------------------------

class PairCfg(ctypes.Structure):
    """Mirror of `struct PairCfg` in csrc/nonbonded.cu."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "natoms", "ntypes", "lj_kind", "elec_kind", "use_cutoff",
        "use_switch", "pbc", "nrep", "it0", "it1")] + [(name, ctypes.c_float) for name in (
            "cutoff2", "switch_dist", "inv_switch_width", "krf", "crf",
            "ewald_alpha", "elec_factor")]


_P = ctypes.c_void_p
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("nonbonded")
        lib.tmd_pair_energy_forces.argtypes = [_P] * 11 + [PairCfg] + [_P] * 5
        lib.tmd_pair_energy_forces.restype = ctypes.c_int
        lib.tmd_pair_scratch_bytes.argtypes = [PairCfg]
        lib.tmd_pair_scratch_bytes.restype = ctypes.c_longlong
        lib.tmd_error_string.argtypes = [ctypes.c_int]
        lib.tmd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def build():
    """Compile and load the kernel library (done at first launch anyway)."""
    _library()


def _energy_dict(kcfg, e_lj, e_el):
    out = {}
    for term in LJ_FAMILY:
        if kcfg[term]:
            out[term] = e_lj
    if kcfg["elec"]:
        out["electrostatics"] = e_el
    return out


def pair_cfg(kcfg, natoms, ntypes, nrep=1, tiles=None) -> PairCfg:
    """The kernel's PairCfg from a `make_kernel_cfg` dict, for `nrep`
    replicas and the i tiles `tiles` = (it0, it1) (None: all)."""
    it0, it1 = (0, -(-natoms // TILE)) if tiles is None else tiles
    lj_kind = (1 if kcfg["lj"] else 2 if kcfg["repulsion"]
               else 3 if kcfg["repulsioncg"] else 0)
    elec_kind = 0
    if kcfg["elec"]:
        elec_kind = (3 if kcfg["ewald_alpha"] is not None
                     else 2 if kcfg["rfa"] and kcfg["cutoff"] is not None else 1)
    cutoff, switch = kcfg["cutoff"], kcfg["switch"]
    use_switch = switch is not None and cutoff is not None
    return PairCfg(
        natoms=natoms, ntypes=ntypes, lj_kind=lj_kind, elec_kind=elec_kind,
        use_cutoff=int(cutoff is not None), use_switch=int(use_switch),
        pbc=int(kcfg["pbc"]), nrep=nrep, it0=int(it0), it1=int(it1),
        cutoff2=cutoff ** 2 if cutoff is not None else 0.0,
        switch_dist=switch if use_switch else 0.0,
        inv_switch_width=1.0 / (cutoff - switch) if use_switch else 0.0,
        krf=kcfg["krf"], crf=kcfg["crf"], ewald_alpha=kcfg["ewald_alpha"] or 0.0,
        elec_factor=kcfg["elec_factor"])


def _launch(data: NBData, cfg, pos, box, stats=None, rows=None):
    global LAUNCHES, ROW_LAUNCHES
    if not supported_terms(cfg):
        raise NotImplementedError(
            "a pair kernel launch takes at most one of lj/repulsion/repulsioncg")
    n, dev, f32, i32 = data.natoms, pos.device, torch.float32, torch.int32
    lead = tuple(pos.shape[:-2])       # () or (R,)
    nrep = pos.shape[0] if lead else 1
    if len(lead) > 1 or nrep < 1:
        raise ValueError(f"pos must be (N, 3) or (R, N, 3), got {tuple(pos.shape)}")
    _build.check_tensor(pos, "pos", f32, lead + (n, 3), dev)
    for name in ("q", "sig", "eps"):
        _build.check_tensor(getattr(data, name), name, f32, (n,), dev)
    _build.check_tensor(data.types, "types", i32, (n,), dev)
    if data.excl_start is None:
        raise ValueError("NBData without its tile exclusions: use prepare_nb_data")
    nt = -(-n // TILE)
    nx = int(data.excl_tile.shape[0])
    _build.check_tensor(data.excl_start, "excl_start", i32, (nt + 1,), dev)
    _build.check_tensor(data.excl_tile, "excl_tile", i32, (nx,), dev)
    _build.check_tensor(data.excl_bits, "excl_bits", i32, (nx, TILE), dev)
    ntypes = 0
    if data.lj_a is not None:
        ntypes = int(data.lj_a.shape[0])
        _build.check_tensor(data.lj_a, "lj_a", f32, (ntypes, ntypes), dev)
        _build.check_tensor(data.lj_b, "lj_b", f32, (ntypes, ntypes), dev)
    if box is not None:
        _build.check_tensor(box, "box", f32, lead + (3,), dev)
    if stats is not None:
        _build.check_tensor(stats, "stats", torch.int64, (len(STATS),), dev)

    kcfg = make_kernel_cfg(cfg, box is not None)
    lo, hi = row_span(n, rows)
    c = pair_cfg(kcfg, n, ntypes, nrep, rows)
    forces = torch.empty(lead + (hi - lo, 3), dtype=f32, device=dev)
    if hi == lo:
        # an empty range: no rows, no pairs
        zero = torch.zeros(lead + (2,), dtype=f32, device=dev)
        return _energy_dict(kcfg, zero[..., 0], zero[..., 1]), forces
    lib = _library()
    scratch = torch.empty(lib.tmd_pair_scratch_bytes(c), dtype=torch.uint8, device=dev)
    energies = torch.empty(lead + (2,), dtype=f32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib.tmd_pair_energy_forces(
        ptr(pos), ptr(data.q), ptr(data.sig), ptr(data.eps), ptr(data.types),
        ptr(data.lj_a), ptr(data.lj_b), ptr(data.excl_start), ptr(data.excl_tile),
        ptr(data.excl_bits), ptr(box), c, ptr(scratch), ptr(forces), ptr(energies),
        ptr(stats), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"pair kernel launch failed: {lib.tmd_error_string(err).decode()}")
    if rows is None:
        LAUNCHES += 1
    else:
        ROW_LAUNCHES += 1
    return _energy_dict(kcfg, energies[..., 0], energies[..., 1]), forces


def pair_terms_reference_batch(data: NBData, cfg, pos, box=None, rows=None):
    """The plain version over a replica ladder: `pair_terms_reference`
    for each replica of pos (R, N, 3) with its box (R, 3) or None,
    stacked: ({term: (R,)}, forces (R, N, 3))."""
    outs = [pair_terms_reference(data, cfg, p, None if box is None else box[r], rows)
            for r, p in enumerate(pos)]
    return ({k: torch.stack([o[0][k] for o in outs]) for k in outs[0][0]},
            torch.stack([o[1] for o in outs]))


def nonbonded_energy_forces(data: NBData, cfg, pos, box=None, stats=None, rows=None):
    """pos: (N, 3), or (R, N, 3) for R replicas of the topology; box:
    (3,) (or (R, 3)) diagonal tensor or None (no PBC). Returns ({term:
    energy tensor, 0-dim (or (R,))}, forces of pos's shape). A CPU tensor
    runs the plain version; a CUDA tensor launches the kernel (f32 only),
    once for all the replicas, or raises. Either runs once per LJ-family
    term (`over_launches`). `stats`, an int64 (5,) card tensor, gains the
    walk's counters (STATS). `rows=(it0, it1)`: the i tiles [it0, it1)
    against all atoms; forces then have the range's rows (module
    docstring; counted in ROW_LAUNCHES)."""
    if pos.device.type == "cuda":
        def one(c):
            return _launch(data, c, pos, box, stats, rows)
    elif pos.device.type == "cpu":
        ref = pair_terms_reference_batch if pos.dim() == 3 else pair_terms_reference

        def one(c):
            return ref(data, c, pos, box, rows)
    else:
        raise ValueError(f"no pair kernel for device {pos.device}")
    return over_launches(cfg, one)
