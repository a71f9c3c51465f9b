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
tensor; on a CUDA tensor it launches or raises. The layout the kernel
walks: the rows binned into cells of edge at least the cutoff over the
rank's region (`HaloGeom.lo`/`hi` on an unwrapped axis, the box on a
wrapped one), each cell's rows owned first and then along a Morton curve
of 4x4x4 sub-cells, in tiles of 32; torch ops compute that order, the
kernel packs the rows, boxes the tiles and walks them (`csrc/halo.cu`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..potentials import LJ_FAMILY, add_energy, nonbonded_block_energy_forces
from ..units import ELEC_FACTOR
from . import _build
from .cell import CellData, pair_fields
from .nonbonded import over_launches, supported_terms

# Kernel launches made by `halo_energy_forces` (one per call on CUDA)
LAUNCHES = 0

TILE = 32             # csrc/tile_pairs.cuh: rows per tile
SUB = 4               # sub-cells per cell edge (Morton order)
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
# CUDA kernel
# ----------------------------------------------------------------------

class HaloCfg(ctypes.Structure):
    """Mirror of `struct HaloCfg` in csrc/halo.cu."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "natoms", "nrows", "nown", "ncx", "ncy", "ncz", "wrapx", "wrapy", "wrapz",
        "ntiles", "nexcl", "ntypes", "lj_kind", "elec_kind", "use_switch")] + [
        (name, ctypes.c_float) for name in (
            "bx", "by", "bz", "cutoff2", "switch_dist", "inv_switch_width", "krf", "crf",
            "ewald_alpha", "elec_factor")]


_P = ctypes.c_void_p
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("halo")
        lib.tmd_halo_energy_forces.argtypes = [_P] * 15 + [HaloCfg] + [_P] * 4
        lib.tmd_halo_energy_forces.restype = ctypes.c_int
        lib.tmd_halo_scratch_bytes.argtypes = [HaloCfg]
        lib.tmd_halo_scratch_bytes.restype = ctypes.c_longlong
        lib.tmd_error_string.argtypes = [ctypes.c_int]
        lib.tmd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def grid(geom: HaloGeom, cutoff):
    """Per axis (origin, cells, cells per A): the box from 0 on a wrapped
    axis, [lo, hi) on an unwrapped one, cut in cells of edge >= cutoff."""
    out = []
    for w, L, lo, hi in zip(geom.wrap, geom.box, geom.lo, geom.hi):
        o, ext = (0.0, float(L)) if w else (float(lo), float(hi) - float(lo))
        nc = max(1, int(ext // cutoff))
        out.append((o, nc, nc / ext))
    return out


def halo_layout(rows, nown, geom: HaloGeom, cutoff, natoms):
    """The kernel's walk order of `rows` (f32 coordinates, torch ops on
    rows' device): (binned coordinates (M, 3), ids, order, cells of the
    sorted rows (-1: padding), cstart, tstart, counts, owned counts, grid
    cells (ncx, ncy, ncz), tiles)."""
    dev, m = rows.device, rows.shape[0]
    ids = rows[:, 0].to(torch.int64)
    valid = ids < natoms
    xyz, cells, sub = [], [], []
    g = grid(geom, cutoff)
    for a, (o, nc, scale) in enumerate(g):
        x = rows[:, 1 + a].float()
        if geom.wrap[a]:
            L = float(geom.box[a])
            x = x - L * torch.floor(x / L)
        f = (x - o) * scale
        c = torch.clamp(torch.floor(f), 0, nc - 1)
        s = torch.clamp(((f - c) * SUB).to(torch.int64), 0, SUB - 1)
        xyz.append(x)
        cells.append(c.to(torch.int64))
        sub.append(s)
    ncx, ncy, ncz = (nc for _, nc, _ in g)
    ncells = ncx * ncy * ncz
    cell = (cells[0] * ncy + cells[1]) * ncz + cells[2]
    morton = torch.zeros_like(cell)
    for bit in range(2):
        for ax in range(3):
            morton = morton | (((sub[ax] >> bit) & 1) << (3 * bit + ax))
    ghost = (torch.arange(m, device=dev) >= nown).to(torch.int64)
    key = torch.where(valid, (cell * 2 + ghost) * 64 + morton,
                      torch.full_like(cell, ncells * 128))
    skey, order = torch.sort(key, stable=True)
    cell_sorted = torch.where(skey < ncells * 128, skey // 128, torch.full_like(skey, -1))
    cv = torch.where(valid, cell, torch.full_like(cell, ncells))

    def count(c):
        # scatter_add: torch.bincount on CUDA reads its size on the host
        return torch.zeros(ncells + 1, dtype=torch.int64, device=dev).scatter_add_(
            0, c, torch.ones_like(c))[:ncells]

    counts = count(cv)
    owned = count(torch.where(ghost == 0, cv, torch.full_like(cv, ncells)))
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    cstart = torch.cat([zero, torch.cumsum(counts, 0)])
    tstart = torch.cat([zero, torch.cumsum((counts + TILE - 1) // TILE, 0)])
    i32 = torch.int32
    return (torch.stack(xyz, 1).contiguous(), ids.to(i32).contiguous(),
            order.to(i32).contiguous(), cell_sorted.to(i32).contiguous(),
            cstart.to(i32).contiguous(), tstart.to(i32).contiguous(),
            counts.to(i32).contiguous(), owned.to(i32).contiguous(), (ncx, ncy, ncz),
            ncells + -(-m // TILE))


def _launch(data: CellData, cfg, rows, nown, geom: HaloGeom):
    global LAUNCHES
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
    check_geometry(geom, float(np.sqrt(fields["cutoff2"])))
    forces = torch.zeros((nown, 3), dtype=f32, device=dev)
    energies = torch.zeros(2, dtype=f32, device=dev)
    if m == 0 or nown == 0:
        return _energies_out(cfg, energies, forces)
    xyz, ids, order, cell_sorted, cstart, tstart, counts, owned, nc, ntiles = halo_layout(
        rows, nown, geom, float(np.sqrt(fields["cutoff2"])), n)
    kcfg = HaloCfg(natoms=n, nrows=m, nown=nown, ncx=nc[0], ncy=nc[1], ncz=nc[2],
                   wrapx=int(geom.wrap[0]), wrapy=int(geom.wrap[1]),
                   wrapz=int(geom.wrap[2]), ntiles=ntiles, nexcl=nexcl, ntypes=ntypes,
                   bx=geom.box[0], by=geom.box[1], bz=geom.box[2], **fields)
    lib = _library()
    scratch = torch.empty(int(lib.tmd_halo_scratch_bytes(kcfg)), dtype=torch.uint8,
                          device=dev)
    tables = (None, None) if data.lj_a is None else (data.lj_a.data_ptr(),
                                                     data.lj_b.data_ptr())
    err = lib.tmd_halo_energy_forces(
        xyz.data_ptr(), ids.data_ptr(), order.data_ptr(), cell_sorted.data_ptr(),
        cstart.data_ptr(), tstart.data_ptr(), counts.data_ptr(), owned.data_ptr(),
        data.q.data_ptr(), data.sig.data_ptr(), data.eps.data_ptr(), data.types.data_ptr(),
        data.excl.data_ptr(), *tables, kcfg, scratch.data_ptr(), forces.data_ptr(),
        energies.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"halo kernel launch failed: {lib.tmd_error_string(err).decode()}")
    LAUNCHES += 1
    return _energies_out(cfg, energies, forces)


def _energies_out(cfg, energies, forces):
    out = {t: energies[0] for t in LJ_FAMILY if t in cfg.terms}
    if "electrostatics" in cfg.terms:
        out["electrostatics"] = energies[1]
    return out, forces


def halo_energy_forces(data: CellData, cfg, rows, nown, geom: HaloGeom):
    """rows: (M, 4) [id, x, y, z], the first `nown` owned; `geom` the
    rank's `HaloGeom`. Returns ({term: 0-dim energy tensor}, forces
    (nown, 3)). A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel (f32 only) or raises. Either runs once per
    LJ-family term (`over_launches`)."""
    if rows.device.type == "cuda":
        def one(c):
            return _launch(data, c, rows, nown, geom)
    elif rows.device.type == "cpu":
        def one(c):
            return halo_reference(data, c, rows, nown, geom)
    else:
        raise ValueError(f"no halo kernel for device {rows.device}")
    return over_launches(cfg, one)
