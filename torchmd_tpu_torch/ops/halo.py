"""The halo pair stage: one rank's owned rows against its owned and ghost
rows -- the CUDA halo kernel, its plain PyTorch version, and the wrapper
that picks between them by device.

Counterpart of the pair stage of `torchmd_tpu/parallel/halo.py`
(`energy_forces_local`, :620-688), which the JAX package computes as one
dense (Acap, Acap + ghosts) block of pair terms. Contract: rows are
(M, 4) [global id, x, y, z] (id `natoms`: padding), the first `nown` of
them this rank's owned atoms and the rest its ghosts; every owned row
meets every owned or ghost row within the cutoff, but for the self pair,
padding and the pairs of the global (natoms, nexcl) exclusion table
(`CellData.excl`, by global id). Charges, sigma/2, sqrt|eps| and LJ
types are read by global id from `CellData` (`ops.cell.
prepare_cell_data`). The ghosts arrive pre-shifted, so x is never
wrapped; `HaloGeom.wrap` says which axes take the minimum image (y on a
slab rank, not on a pencil rank; z always). Pair terms as the other pair
kernels (LJ with the switch, repulsion or repulsioncg, NBFIX A/B by type
pair or Lorentz-Berthelot, Coulomb plain / reaction field / Ewald erfc);
energies carry the 0.5 symmetric factor, forces (nown, 3) are complete on
the owned rows. The Ewald erf correction of excluded pairs is not part of
it (`parallel.halo` adds it).

`halo_energy_forces(data, cfg, rows, nown, geom)` runs the plain version
for a CPU tensor and launches the kernel (`csrc/halo.cu`, f32) for a CUDA
tensor; on a CUDA tensor it launches or raises, and no torch op runs
between `rows` and the launch. The layout the kernel walks, which its own
prep pass builds on the device from the raw rows: the rows binned into
cells of edge at least the cutoff over the rank's region (`HaloGeom.lo`/
`hi` on an unwrapped axis, the box on a wrapped one, coordinates wrapped
into it), cell-major; each cell's owned rows first, then its ghosts, each
class along a Morton curve of 4x4x4 sub-cells and then by row index; 32
rows a tile, each tile with its tight box. `halo_tiles_reference` is that
prep pass's plain version and `halo_tiles` runs it alone on the card.
The kernel sorts a cell of more than PREP_CAP rows from device memory
(no row is dropped) and raises the optional `overflow` flag to its row
count; `check_overflow` turns the flag into an error for callers of the
bare wrapper. `parallel.HaloMD` reads it with its per-step host read,
counts it and steps on. The plain version has no cap.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from ..potentials import LJ_FAMILY, add_energy, nonbonded_block_energy_forces
from ..units import ELEC_FACTOR
from . import _build
from .cell import CellData, pack_rows, pair_fields, tile_boxes
from .nonbonded import STATS, over_launches, supported_terms

# Kernel launches made by `halo_energy_forces` (one per call on CUDA)
LAUNCHES = 0

TILE = 32             # csrc/tile_pairs.cuh: rows per tile
SUB = 4               # csrc/halo.cu: sub-cells per cell edge (Morton order)
PREP_CAP = 1024       # csrc/halo.cu: rows a cell's prep block sorts in shared memory
REFERENCE_ROWS = 256  # owned rows per block of the plain version (bounds memory)


class HaloGeom(NamedTuple):
    """Where one rank's rows lie: the box, which axes wrap, and on an
    unwrapped axis the region [lo, hi) its rows fill (rows beyond it are
    binned into its end cells)."""

    box: tuple           # (lx, ly, lz)
    wrap: tuple          # (bool, bool, bool)
    lo: tuple            # per axis; read on unwrapped axes only
    hi: tuple


def check_geometry(geom: HaloGeom, cutoff):
    """Raise unless every wrapped box edge holds two cutoffs (the minimum
    image then has at most one image of a pair inside the cutoff)."""
    for a, (w, L) in enumerate(zip(geom.wrap, geom.box)):
        if w and L < 2.0 * cutoff:
            raise ValueError(f"box edge {L} along axis {a} < twice the cutoff {cutoff}")


# ----------------------------------------------------------------------
# Plain PyTorch version
# ----------------------------------------------------------------------

def halo_reference(data: CellData, cfg, rows, nown, geom: HaloGeom):
    """Plain version of the halo kernel, at the dtype and on the device of
    `rows`: blocks of REFERENCE_ROWS owned rows against all rows through
    `potentials.nonbonded_block_energy_forces`. Returns ({term: energy},
    forces (nown, 3))."""
    n, dt, dev = data.natoms, rows.dtype, rows.device
    ids = rows[:, 0].long()
    valid = ids < n
    pos = rows[:, 1:4]
    box = torch.tensor(geom.box, dtype=dt, device=dev)
    wrap = torch.tensor(geom.wrap, device=dev)

    def padded(a, fill):
        return torch.cat([a, torch.full_like(a[:1], fill)])

    q = padded(data.q.to(dt), 0.0)[ids]
    want_lj = any(t in cfg.terms for t in LJ_FAMILY)
    if want_lj and data.lj_a is not None:
        types = padded(data.types.long(), 0)[ids]
        lj_a, lj_b = data.lj_a.to(dt), data.lj_b.to(dt)
    elif want_lj:
        sig, eps = padded(data.sig.to(dt), 0.0)[ids], padded(data.eps.to(dt), 0.0)[ids]
    excl = padded(data.excl.long(), n)[ids[:nown]] if data.excl.shape[1] else None
    pot: dict = {}
    forces = torch.zeros((nown, 3), dtype=dt, device=dev)
    for b in range(0, nown, REFERENCE_ROWS):
        e = min(nown, b + REFERENCE_ROWS)
        dv = pos[b:e, None, :] - pos[None, :, :]
        dv = torch.where(wrap, dv - box * torch.round(dv / box), dv)
        mask = valid[b:e, None] & valid[None, :] & (ids[b:e, None] != ids[None, :])
        if excl is not None:
            mask = mask & ~(excl[b:e, :, None] == ids[None, None, :]).any(1)
        qq = A = B = None
        if "electrostatics" in cfg.terms:
            qq = ELEC_FACTOR * q[b:e, None] * q[None, :]
        if want_lj and data.lj_a is not None:
            A = lj_a[types[b:e, None], types[None, :]]
            B = lj_b[types[b:e, None], types[None, :]]
        elif want_lj:
            s6 = (sig[b:e, None] + sig[None, :]) ** 6
            B = 4.0 * eps[b:e, None] * eps[None, :] * s6
            A = B * s6
        block, f = nonbonded_block_energy_forces(cfg, dv, mask, qq, A, B)
        forces[b:e] = f
        for k, v in block.items():
            add_energy(pot, k, v)
    if not pot:
        # no owned rows: the terms' zero energies
        for k in [t for t in LJ_FAMILY if t in cfg.terms] + (
                ["electrostatics"] if "electrostatics" in cfg.terms else []):
            pot[k] = torch.zeros((), dtype=dt, device=dev)
    return pot, forces


# ----------------------------------------------------------------------
# The layout: the kernel's prep pass and its plain version
# ----------------------------------------------------------------------

class HaloTiles(NamedTuple):
    """The layout the halo kernel walks, as its prep pass writes it."""

    pq: torch.Tensor         # (S, 4) f32: binned x, y, z, q per slot
    aux: torch.Tensor        # (S, 4) f32: sigma/2, sqrt|eps|, id, LJ type (int32 bits)
    tbox: torch.Tensor       # (T, 2, 4) f32: lo and hi corner (w = 0) per tile
    rowof: torch.Tensor      # (S,) int32: each slot's row of `rows` (-1: padding)
    tile_cell: torch.Tensor  # (T,) int32: each tile's cell


def grid(geom: HaloGeom, cutoff):
    """Per axis (origin, cells, cells per A): the box from 0 on a wrapped
    axis, [lo, hi) on an unwrapped one, cut in cells of edge >= cutoff."""
    out = []
    for w, L, lo, hi in zip(geom.wrap, geom.box, geom.lo, geom.hi):
        o, ext = (0.0, float(L)) if w else (float(lo), float(hi) - float(lo))
        nc = max(1, int(ext // cutoff))
        out.append((o, nc, nc / ext))
    return out


def _f32(x):
    return float(np.float32(x))


def _axes(geom: HaloGeom, cutoff):
    """Per axis the binning's constants as csrc/halo.cu reads them, each
    rounded to f32: (wraps, box edge, its reciprocal, origin, cells, cells
    per A)."""
    return [(bool(w), _f32(L), _f32(1.0 / float(L)), _f32(o), nc, _f32(s))
            for w, L, (o, nc, s) in zip(geom.wrap, geom.box, grid(geom, cutoff))]


def _cutoff(cfg):
    return math.sqrt(pair_fields(cfg)["cutoff2"])


def _bin(rows, nown, geom: HaloGeom, cutoff, natoms):
    """csrc/halo.cu's `halo_bin` in torch ops, in its f32 arithmetic:
    (ids (M,) int64, binned coordinates (M, 3) f32, each row's cell (-1:
    padding) and class code ghost * 64 + Morton index, int64, and the
    grid's cells per axis)."""
    m = rows.shape[0]
    ids = rows[:, 0].to(torch.int64)
    xyz, cells, sub = [], [], []
    axes = _axes(geom, cutoff)
    for a, (wrap, L, inv, o, nc, s) in enumerate(axes):
        x = rows[:, 1 + a].float()
        if wrap:
            x = x - L * torch.floor(x * inv)
        f = (x - o) * s
        c = torch.clamp(torch.floor(f), 0, nc - 1)
        sub.append(torch.clamp(((f - c) * SUB).to(torch.int64), 0, SUB - 1))
        xyz.append(x)
        cells.append(c.to(torch.int64))
    dims = tuple(ax[4] for ax in axes)
    cell = (cells[0] * dims[1] + cells[1]) * dims[2] + cells[2]
    cell = torch.where(ids < natoms, cell, torch.full_like(cell, -1))
    code = (torch.arange(m, device=rows.device) >= nown).to(torch.int64) * 64
    for bit in range(2):
        for ax in range(3):
            code = code | (((sub[ax] >> bit) & 1) << (3 * bit + ax))
    return ids, torch.stack(xyz, 1), cell, code, dims


def halo_tiles_reference(data: CellData, cfg, rows, nown, geom: HaloGeom) -> HaloTiles:
    """Plain version of the halo kernel's prep pass, torch ops on the
    device of `rows` (f32 coordinates): each real row once, cell-major;
    within a cell the owned rows, then the ghosts, each class in Morton
    order of its sub-cells and then by row index; each cell in
    ceil(count / 32) tiles of 32 slots, the last one padded; each tile's
    tight box over its rows."""
    n, dev = data.natoms, rows.device
    m = rows.shape[0]
    ids, xyz, cell, code, dims = _bin(rows, nown, geom, _cutoff(cfg), n)
    ncells = math.prod(dims)
    valid = cell >= 0
    r = torch.arange(m, device=dev)
    key = torch.where(valid, (cell * 128 + code) * m + r, torch.full_like(r, ncells * 128 * m))
    order = torch.argsort(key)[:int(valid.sum())]
    counts = torch.bincount(cell[valid], minlength=ncells)
    ntile = (counts + TILE - 1) // TILE
    cell_s = cell[order]
    first = (torch.cumsum(ntile, 0) - ntile) * TILE - (torch.cumsum(counts, 0) - counts)
    slot = first[cell_s] + torch.arange(len(order), device=dev)
    nslots = int(ntile.sum()) * TILE
    ids_s = torch.full((nslots,), n, dtype=torch.int64, device=dev)
    ids_s[slot] = ids[order]
    xyz_s = torch.zeros((nslots, 3), dtype=torch.float32, device=dev)
    xyz_s[slot] = xyz[order]
    valid_s = torch.zeros(nslots, dtype=torch.bool, device=dev)
    valid_s[slot] = True
    rowof = torch.full((nslots,), -1, dtype=torch.int32, device=dev)
    rowof[slot] = order.to(torch.int32)
    pq, aux = pack_rows(xyz_s, ids_s, valid_s, data.q, data.sig, data.eps, n, data.types)
    tile_cell = torch.repeat_interleave(torch.arange(ncells, device=dev), ntile)
    return HaloTiles(pq, aux, tile_boxes(xyz_s, valid_s), rowof, tile_cell.to(torch.int32))


def overflow_error(count, rank=0, ranks=1) -> RuntimeError:
    """The error of a cell of `count` rows, beyond PREP_CAP, on halo rank
    `rank` of `ranks`."""
    where = "" if ranks == 1 else f" on rank {rank} of {ranks}"
    return RuntimeError(
        f"halo pair kernel: a cell holds {count} rows{where}, more than the {PREP_CAP} its "
        "prep pass sorts in shared memory (it sorted them from device memory: no row was "
        "dropped, but such a cell means atoms piled up far beyond any liquid density)")


def check_overflow(overflow):
    """Raise `overflow_error` if the `overflow` flag of
    `halo_energy_forces` / `halo_tiles` is set (a host read)."""
    count = int(overflow.max())
    if count > 0:
        raise overflow_error(count)


# ----------------------------------------------------------------------
# CUDA kernel
# ----------------------------------------------------------------------

class HaloCfg(ctypes.Structure):
    """Mirror of `struct HaloCfg` in csrc/halo.cu."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "natoms", "nrows", "nown", "ncx", "ncy", "ncz", "wrapx", "wrapy", "wrapz",
        "ntiles", "nwalk", "nexcl", "ntypes", "lj_kind", "elec_kind", "use_switch")] + [
        (name, ctypes.c_float) for name in (
            "bx", "by", "bz", "ibx", "iby", "ibz", "ox", "oy", "oz", "sx", "sy", "sz",
            "cutoff2", "switch_dist", "inv_switch_width", "krf", "crf", "ewald_alpha",
            "elec_factor")]


# csrc/halo.cu's `Carve`: the scratch arrays read back, by index, and the
# number of entries (the last is the scratch size)
PQ, AUX, TBOX, ROWOF, TILE_CELL, COUNTS, OWNED, TSTART, WSTART = range(9)
NCARVE = 18

_P = ctypes.c_void_p
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("halo")
        lib.tmd_halo_energy_forces.argtypes = [_P] * 8 + [HaloCfg] + [_P] * 6
        lib.tmd_halo_energy_forces.restype = ctypes.c_int
        lib.tmd_halo_prep.argtypes = [_P] * 5 + [HaloCfg] + [_P] * 3
        lib.tmd_halo_prep.restype = ctypes.c_int
        lib.tmd_halo_carve.argtypes = [HaloCfg, ctypes.POINTER(ctypes.c_longlong)]
        lib.tmd_halo_carve.restype = None
        lib.tmd_error_string.argtypes = [ctypes.c_int]
        lib.tmd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _kernel_cfg(data: CellData, cfg, rows, nown, geom: HaloGeom) -> HaloCfg:
    """Raise on what the kernel does not take; its HaloCfg."""
    if not supported_terms(cfg):
        raise NotImplementedError(
            "a halo kernel launch takes at most one of lj/repulsion/repulsioncg")
    n, dev, f32, i32 = data.natoms, rows.device, torch.float32, torch.int32
    m = int(rows.shape[0])
    if not 0 <= nown <= m:
        raise ValueError(f"nown={nown} outside the {m} rows")
    _build.check_tensor(rows, "rows", f32, (m, 4), dev)
    for name in ("q", "sig", "eps"):
        _build.check_tensor(getattr(data, name), name, f32, (n,), dev)
    _build.check_tensor(data.types, "types", i32, (n,), dev)
    nexcl = int(data.excl.shape[1])
    _build.check_tensor(data.excl, "excl", i32, (n, nexcl), dev)
    ntypes = 0
    if data.lj_a is not None:
        ntypes = int(data.lj_a.shape[0])
        _build.check_tensor(data.lj_a, "lj_a", f32, (ntypes, ntypes), dev)
        _build.check_tensor(data.lj_b, "lj_b", f32, (ntypes, ntypes), dev)
    fields = pair_fields(cfg)
    cutoff = math.sqrt(fields["cutoff2"])
    check_geometry(geom, cutoff)
    axes = _axes(geom, cutoff)
    kw = {}
    for a, (wrap, L, inv, o, nc, s) in zip("xyz", axes):
        kw.update({f"wrap{a}": int(wrap), f"b{a}": L, f"ib{a}": inv, f"o{a}": o,
                   f"nc{a}": nc, f"s{a}": s})
    ncells = math.prod(ax[4] for ax in axes)
    return HaloCfg(natoms=n, nrows=m, nown=nown, ntiles=ncells + -(-m // TILE),
                   nwalk=ncells + -(-nown // TILE), nexcl=nexcl, ntypes=ntypes, **kw,
                   **fields)


def _scratch(lib, kcfg, dev):
    """(scratch tensor, csrc/halo.cu's byte offsets into it)."""
    off = (ctypes.c_longlong * NCARVE)()
    lib.tmd_halo_carve(kcfg, off)
    return torch.empty(int(off[NCARVE - 1]), dtype=torch.uint8, device=dev), list(off)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_flags(overflow, stats, dev):
    if overflow is not None:
        _build.check_tensor(overflow, "overflow", torch.int32, (1,), dev)
    if stats is not None:
        _build.check_tensor(stats, "stats", torch.int64, (len(STATS),), dev)


def _launch(data: CellData, cfg, rows, nown, geom: HaloGeom, overflow=None, stats=None):
    global LAUNCHES
    kcfg = _kernel_cfg(data, cfg, rows, nown, geom)
    dev = rows.device
    _check_flags(overflow, stats, dev)
    if kcfg.nrows == 0 or nown == 0:
        return _energies_out(cfg, torch.zeros(2, dtype=torch.float32, device=dev),
                             torch.zeros((nown, 3), dtype=torch.float32, device=dev))
    forces = torch.empty((nown, 3), dtype=torch.float32, device=dev)
    energies = torch.empty(2, dtype=torch.float32, device=dev)
    lib = _library()
    scratch, _ = _scratch(lib, kcfg, dev)
    err = lib.tmd_halo_energy_forces(
        rows.data_ptr(), data.q.data_ptr(), data.sig.data_ptr(), data.eps.data_ptr(),
        data.types.data_ptr(), data.excl.data_ptr(), _ptr(data.lj_a), _ptr(data.lj_b), kcfg,
        scratch.data_ptr(), _ptr(overflow), forces.data_ptr(), energies.data_ptr(),
        _ptr(stats), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"halo kernel launch failed: {lib.tmd_error_string(err).decode()}")
    LAUNCHES += 1
    return _energies_out(cfg, energies, forces)


def halo_tiles(data: CellData, cfg, rows, nown, geom: HaloGeom, overflow=None) -> HaloTiles:
    """The kernel's prep pass alone on a CUDA tensor (for tests): the
    layout as `halo_tiles_reference` gives it (one host read: the number
    of tiles the cells fill)."""
    kcfg = _kernel_cfg(data, cfg, rows, nown, geom)
    dev = rows.device
    _check_flags(overflow, None, dev)
    lib = _library()
    scratch, off = _scratch(lib, kcfg, dev)
    err = lib.tmd_halo_prep(
        rows.data_ptr(), data.q.data_ptr(), data.sig.data_ptr(), data.eps.data_ptr(),
        data.types.data_ptr(), kcfg, scratch.data_ptr(), _ptr(overflow),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"halo prep launch failed: {lib.tmd_error_string(err).decode()}")

    def array(k, dtype, count):
        return scratch[off[k]:off[k] + 4 * count].view(dtype)

    ncells = kcfg.ncx * kcfg.ncy * kcfg.ncz
    t = int(array(TSTART, torch.int32, ncells + 1)[ncells])
    s = t * TILE
    return HaloTiles(array(PQ, torch.float32, 4 * s).view(s, 4),
                     array(AUX, torch.float32, 4 * s).view(s, 4),
                     array(TBOX, torch.float32, 8 * t).view(t, 2, 4),
                     array(ROWOF, torch.int32, s), array(TILE_CELL, torch.int32, t))


def _energies_out(cfg, energies, forces):
    out = {t: energies[0] for t in LJ_FAMILY if t in cfg.terms}
    if "electrostatics" in cfg.terms:
        out["electrostatics"] = energies[1]
    return out, forces


def halo_energy_forces(data: CellData, cfg, rows, nown, geom: HaloGeom, overflow=None,
                       stats=None):
    """rows: (M, 4) [id, x, y, z], the first `nown` owned; `geom` the
    rank's `HaloGeom`. Returns ({term: 0-dim energy tensor}, forces
    (nown, 3)). A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel (f32 only) or raises. Either runs once per
    LJ-family term (`over_launches`). `overflow`, an int32 (1,) tensor on
    the card, is raised by the kernel to the row count of a cell beyond
    PREP_CAP (`check_overflow` reads it; the plain version has no cap and
    leaves it as it is); `stats`, an int64 (NSTATS,) tensor on the card,
    gains the walk's counters (`ops.nonbonded.STATS`)."""
    if rows.device.type == "cuda":
        def one(c):
            return _launch(data, c, rows, nown, geom, overflow, stats)
    elif rows.device.type == "cpu":
        def one(c):
            return halo_reference(data, c, rows, nown, geom)
    else:
        raise ValueError(f"no halo kernel for device {rows.device}")
    return over_launches(cfg, one)
