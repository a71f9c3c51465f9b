"""Cell-list nonbonded energy + forces: the CUDA cell kernel, its plain
PyTorch version, and the wrapper that picks between them by device.

Counterpart of `torchmd_tpu/ops/pallas_cell.py` (`pallas_cell_energy_forces`)
and of `neighbors.cell_nonbonded_energy_forces`, whose contract it computes:
the pairs of each cell's atoms with the atoms of its 27 neighbouring cells
(a 3x3x3 stencil of cells with edge >= cutoff + skin), periodic images as
a per-neighbour-cell shift of the anchored positions, exclusions from a
padded per-atom list, the cutoff on d^2, and the pair terms of the dense
kernel (LJ with the switch, repulsion or repulsioncg, Coulomb plain /
reaction field / Ewald erfc), Lorentz-Berthelot from per-atom rows or
NBFIX A/B tables by type pair. Energies carry the 0.5 symmetric factor
(every pair is seen from both of its cells); forces are per atom. With
`with_virial=True` the per-axis pair virial -0.5 sum g d_a^2 (the MTK
barostat's -dE/ds_a) comes back too. With `slab=(cx0, nloc)` only the
cells of the x columns [cx0, min(cx0 + nloc, ncx)) take their i atoms
(the spatially sharded path's slab, the JAX package's rule at
torchmd_tpu/neighbors.py:340-380): their atoms' forces and their half of
the pair energies, zero forces elsewhere, so the slabs of the ranks sum
to the full call. Cells are x-major, so a slab is a contiguous range of
cells, of the kernel's blocks and of its energy partials.

`cell_energy_forces(data, cfg, clcfg, cl, pos, box)` runs the plain
version for a CPU tensor and launches the kernel (`csrc/cell.cu`) for a
CUDA tensor; on a CUDA tensor it launches or raises. A term set with more
than one LJ-family term takes one launch per such term
(`nonbonded.over_launches`), on either device. The kernel walks
32-atom tiles (`csrc/tile_pairs.cuh`): its prep pass orders each cell's
atoms along a Morton curve of 4x4x4 sub-cells into packed rows with a
bounding box per tile; `cell_tiles_reference` is that pass's plain
version.
"""

from __future__ import annotations

import ctypes
import itertools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..potentials import LJ_FAMILY, add_energy, nonbonded_block_energy_forces
from ..units import ELEC_FACTOR
from . import _build
from .nonbonded import STATS, atom_rows, make_kernel_cfg, over_launches, supported_terms

# Kernel launches made by `cell_energy_forces` (one per call on CUDA),
# and those of its slab form (`slab=`, the spatially sharded path)
LAUNCHES = 0
SLAB_LAUNCHES = 0

MAX_CAPACITY = 1024  # csrc/cell.cu: slot ranks pack into 10 bits
TILE = 32            # csrc/tile_pairs.cuh: atoms per tile
SUB = 4              # csrc/cell.cu: sub-cells per cell edge (Morton order)
FAR = 1e18           # csrc/tile_pairs.cuh: padding coordinate, empty-box bound
NSTATS = len(STATS)  # csrc/tile_pairs.cuh Counters
STENCIL = tuple(itertools.product((-1, 0, 1), repeat=3))


class CellData(NamedTuple):
    """Per-atom rows and exclusion lists, prepared once per topology."""

    natoms: int
    q: torch.Tensor                     # (N,) charges
    sig: torch.Tensor                   # (N,) sigma/2
    eps: torch.Tensor                   # (N,) sqrt|epsilon|
    types: torch.Tensor                 # (N,) int32 LJ type
    excl: torch.Tensor                  # (N, E) int32, N = empty
    lj_a: Optional[torch.Tensor] = None  # (T, T) NBFIX A table
    lj_b: Optional[torch.Tensor] = None  # (T, T) NBFIX B table


def prepare_cell_data(ffp, excl_table, dtype=None) -> CellData:
    """Kernel inputs from FFParams and a (natoms, E) exclusion table
    (`neighbors.build_exclusion_table`), on ffp's device."""
    excl = torch.as_tensor(np.array(excl_table), dtype=torch.int32,
                           device=ffp.charges.device)
    return CellData(excl=excl.contiguous(), **atom_rows(ffp, dtype))


# ----------------------------------------------------------------------
# Plain PyTorch version
# ----------------------------------------------------------------------

def _image_shift(clcfg, box, offset, like):
    """(ncx, ncy, ncz, 1, 3) position shift of the neighbour cell at
    `offset` from each cell: +-box where the stencil wraps around a face."""
    axes = []
    for ax, (d, nc) in enumerate(zip(offset, clcfg.ncells)):
        wraps = torch.div(torch.arange(nc, device=like.device) + d, nc,
                          rounding_mode="floor")
        shape = [1, 1, 1]
        shape[ax] = nc
        axes.append((wraps.to(like.dtype) * box[ax]).reshape(shape))
    return torch.stack(torch.broadcast_tensors(*axes), dim=-1)[..., None, :]


def slab_cells(clcfg, slab):
    """The cell range [c0, c1) of `slab` = (cx0, nloc) (None: all cells);
    empty when cx0 >= ncx."""
    ncx, ncy, ncz = clcfg.ncells
    if slab is None:
        return 0, ncx * ncy * ncz
    cx0, nloc = (int(v) for v in slab)
    if cx0 < 0 or nloc < 1:
        raise ValueError(f"slab {slab}: want cx0 >= 0 and nloc >= 1")
    lo, hi = min(cx0, ncx), min(cx0 + nloc, ncx)
    return lo * ncy * ncz, hi * ncy * ncz


def cell_reference(data: CellData, cfg, clcfg, cl, pos, box, with_virial=False, slab=None):
    """Plain PyTorch version of the cell kernel: the 27 stencil offsets in
    turn, each a (ncells * cap, cap) pair block through the port's
    `nonbonded_block_energy_forces`, at the dtype and on the device of
    `pos`; with `slab`, only the slab's cells' atoms as i atoms. Returns
    ({term: energy}, forces (N, 3)[, virial (3,)])."""
    from ..neighbors import anchored_positions

    n, dt, dev = data.natoms, pos.dtype, pos.device
    grid = tuple(clcfg.ncells)
    ncells, cap = int(np.prod(grid)), clcfg.capacity
    rows = ncells * cap
    box = torch.as_tensor(box, dtype=dt, device=dev).reshape(3)
    slots = cl.slots.long()

    def slot_rows(a, fill):
        pad = torch.cat([a, torch.full_like(a[:1], fill)])
        return pad[slots].reshape(grid + (cap,) + a.shape[1:])

    def roll(a, offset):
        return torch.roll(a, shifts=tuple(-d for d in offset), dims=(0, 1, 2))

    P = slot_rows(anchored_positions(pos, cl.ref_pos.to(dt), box), 0.0)
    Q = slot_rows(data.q.to(dt), 0.0)
    ids = slots.reshape(grid + (cap,))
    ids_i = slots.reshape(rows)
    valid_i = ids_i < n
    if slab is not None:
        c0, c1 = slab_cells(clcfg, slab)
        cell_i = torch.arange(rows, device=dev) // cap
        valid_i = valid_i & (cell_i >= c0) & (cell_i < c1)
    nexcl = data.excl.shape[1]
    EX = slot_rows(data.excl.long(), n).reshape(rows, 1, nexcl)
    want_lj = any(t in cfg.terms for t in LJ_FAMILY)
    if want_lj and data.lj_a is not None:
        T = slot_rows(data.types.long(), 0)
    elif want_lj:
        S, E = slot_rows(data.sig.to(dt), 0.0), slot_rows(data.eps.to(dt), 0.0)

    def pair_block(a_i, a_j):
        """a_i per i slot as (ncells, cap, 1), a_j per j slot as
        (ncells, 1, cap): operands that broadcast to the pair block."""
        return a_i.reshape(ncells, cap, 1), a_j.reshape(ncells, 1, cap)

    pot: dict = {}
    f_slots = torch.zeros((rows, 3), dtype=dt, device=dev)
    vir = torch.zeros(3, dtype=dt, device=dev)
    for offset in STENCIL:
        Pn = roll(P, offset) + _image_shift(clcfg, box, offset, P)
        dv = (P.reshape(ncells, cap, 1, 3)
              - Pn.reshape(ncells, 1, cap, 3)).reshape(rows, cap, 3)
        idn = roll(ids, offset).reshape(ncells, 1, cap).expand(
            ncells, cap, cap).reshape(rows, cap)
        mask = valid_i[:, None] & (idn < n) & (ids_i[:, None] != idn)
        if nexcl:
            mask = mask & ~(EX == idn[:, :, None]).any(-1)
        qq = A = B = None
        if "electrostatics" in cfg.terms:
            qi, qj = pair_block(Q, roll(Q, offset))
            qq = (ELEC_FACTOR * qi * qj).reshape(rows, cap)
        if want_lj and data.lj_a is not None:
            ti, tj = pair_block(T, roll(T, offset))
            A = data.lj_a.to(dt)[ti, tj].reshape(rows, cap)
            B = data.lj_b.to(dt)[ti, tj].reshape(rows, cap)
        elif want_lj:
            si, sj = pair_block(S, roll(S, offset))
            ei, ej = pair_block(E, roll(E, offset))
            s6 = ((si + sj) ** 6).reshape(rows, cap)
            B = 4.0 * (ei * ej).reshape(rows, cap) * s6
            A = B * s6
        block, f_rows, *v = nonbonded_block_energy_forces(
            cfg, dv, mask, qq, A, B, with_virial=with_virial)
        f_slots = f_slots + f_rows
        if with_virial:
            vir = vir + v[0]
        for k, v in block.items():
            add_energy(pot, k, v)
    forces = torch.zeros((n + 1, 3), dtype=dt, device=dev).index_add_(
        0, slots.reshape(-1), f_slots)[:n]
    if with_virial:
        return pot, forces, vir
    return pot, forces


class Tiles(NamedTuple):
    """The packed rows and tile boxes of a tile kernel's prep pass."""

    pq: torch.Tensor     # (S, 4) f32: x, y, z, q per packed slot
    aux: torch.Tensor    # (S, 4) f32: sigma/2, sqrt|eps|, id, LJ type (int32 bits)
    tbox: torch.Tensor   # (T, 2, 4) f32: lo and hi corner (w = 0) per tile

    @property
    def ids(self):
        return self.aux[:, 2].contiguous().view(torch.int32)


def pack_rows(xyz, ids, valid, q, sig, eps, natoms, types=None):
    """Packed rows (pq, aux) of slots holding atoms `ids` at positions
    `xyz` (S, 3) where `valid`; padding rows are (FAR, FAR, FAR, 0) and
    (0, 0, id natoms, type 0). `types` (N,) int: the LJ types in aux's w
    (the cell kernel's NBFIX tables read them), else 0."""
    safe = torch.where(valid, ids, torch.zeros_like(ids)).long()

    def rows(a, fill):
        return torch.where(valid, a.float()[safe], torch.full_like(a.float()[safe], fill))

    pq = torch.cat([torch.where(valid[:, None], xyz.float(), torch.full_like(xyz.float(), FAR)),
                    rows(q, 0.0)[:, None]], 1)
    idf = torch.where(valid, ids, torch.full_like(ids, natoms)).to(torch.int32)
    tw = torch.zeros_like(idf)
    if types is not None:
        tw = torch.where(valid, types.to(torch.int32)[safe], tw)
    aux = torch.stack([rows(sig, 0.0), rows(eps, 0.0), idf.view(torch.float32),
                       tw.view(torch.float32)], 1)
    return pq, aux


def tile_boxes(xyz, valid):
    """(T, 2, 4) lo/hi corners of each run of TILE rows of `xyz` (S, 3),
    over its `valid` rows; a tile without one gets lo = FAR, hi = -FAR."""
    t = xyz.shape[0] // TILE
    x = xyz[:t * TILE].reshape(t, TILE, 3)
    v = valid[:t * TILE].reshape(t, TILE, 1)
    lo = torch.where(v, x, torch.full_like(x, FAR)).amin(1)
    hi = torch.where(v, x, torch.full_like(x, -FAR)).amax(1)
    box = torch.stack([lo, hi], 1)
    return torch.cat([box, torch.zeros_like(box[..., :1])], -1)


def sub_cells(pos, clcfg, cell3, box):
    """Morton index of each atom's sub-cell (SUB per cell edge) within its
    cell `cell3` (N, 3), in csrc/cell.cu's f32 arithmetic."""
    scale = torch.tensor(clcfg.ncells, dtype=torch.float32, device=pos.device) / box.float()
    f = (pos.float() * scale - cell3.float()) * SUB
    s = torch.clamp(f.to(torch.int32), 0, SUB - 1)
    key = torch.zeros_like(s[:, 0])
    for bit in range(2):
        for ax in range(3):
            key = key | (((s[:, ax] >> bit) & 1) << (3 * bit + ax))
    return key


def cell_tiles_reference(data: CellData, clcfg, cl, pos_w, box) -> Tiles:
    """Plain version of the cell kernel's prep pass on anchored f32
    positions `pos_w`: each cell's atoms in the order of their sub-cells'
    Morton index (ties by slot), packed, and each TILE-slot tile's box.
    Slots past a cell's count hold padding."""
    n, dev = data.natoms, pos_w.device
    ncells, cap = int(np.prod(clcfg.ncells)), clcfg.capacity
    tpc = -(-cap // TILE)
    counts = torch.clamp(cl.counts.long(), max=cap)
    ar = torch.arange(cap, device=dev)
    valid = ar[None, :] < counts[:, None]
    ids = torch.where(valid, cl.slots.long(), torch.full_like(cl.slots.long(), n))
    c = torch.arange(ncells, device=dev)
    nx, ny, nz = clcfg.ncells
    cell3 = torch.stack([c // (ny * nz), (c // nz) % ny, c % nz], 1)
    pos_pad = torch.cat([pos_w.float(), torch.zeros_like(pos_w[:1]).float()])
    key = sub_cells(pos_pad[ids].reshape(-1, 3), clcfg,
                    cell3.repeat_interleave(cap, 0), box).reshape(ncells, cap)
    key = torch.where(valid, key.long() * MAX_CAPACITY + ar, torch.full_like(key.long(), 1 << 40))
    order = torch.argsort(key, dim=1)
    ids_s = torch.gather(ids, 1, order).reshape(-1)
    valid_s = valid.reshape(-1)
    pq, aux = pack_rows(pos_pad[ids_s], ids_s, valid_s, data.q, data.sig, data.eps, n,
                        data.types)
    pad = tpc * TILE - cap
    xyz = torch.cat([pq[:, :3].reshape(ncells, cap, 3),
                     torch.zeros((ncells, pad, 3), device=dev)], 1).reshape(-1, 3)
    vt = torch.cat([valid, torch.zeros((ncells, pad), dtype=torch.bool, device=dev)],
                   1).reshape(-1)
    return Tiles(pq, aux, tile_boxes(xyz, vt))


# ----------------------------------------------------------------------
# CUDA kernel
# ----------------------------------------------------------------------

class CellCfg(ctypes.Structure):
    """Mirror of `struct CellCfg` in csrc/cell.cu."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "natoms", "capacity", "ncx", "ncy", "ncz", "nexcl", "ntypes", "lj_kind",
        "elec_kind", "use_switch", "cell0", "cell1")] + [(name, ctypes.c_float) for name in (
            "cutoff2", "switch_dist", "inv_switch_width", "krf", "crf",
            "ewald_alpha", "elec_factor")]


_P = ctypes.c_void_p
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("cell")
        lib.tmd_cell_energy_forces.argtypes = ([_P] * 11 + [CellCfg, ctypes.c_int]
                                               + [_P] * 5)
        lib.tmd_cell_energy_forces.restype = ctypes.c_int
        lib.tmd_cell_prep.argtypes = [_P] * 8 + [CellCfg] + [_P] * 2
        lib.tmd_cell_prep.restype = ctypes.c_int
        lib.tmd_cell_scratch_bytes.argtypes = [CellCfg]
        lib.tmd_cell_scratch_bytes.restype = ctypes.c_longlong
        lib.tmd_error_string.argtypes = [ctypes.c_int]
        lib.tmd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def build():
    """Compile and load the kernel library (done at first launch anyway)."""
    _library()


def pair_fields(cfg) -> dict:
    """The pair-term fields shared by the cell and column kernels' config
    structs (the meanings of `Cfg` in csrc/pair_terms.cuh)."""
    kcfg = make_kernel_cfg(cfg, True)
    lj_kind = (1 if kcfg["lj"] else 2 if kcfg["repulsion"]
               else 3 if kcfg["repulsioncg"] else 0)
    elec_kind = 0
    if kcfg["elec"]:
        elec_kind = 3 if kcfg["ewald_alpha"] is not None else 2 if kcfg["rfa"] else 1
    use_switch = kcfg["switch"] is not None
    return dict(
        lj_kind=lj_kind, elec_kind=elec_kind,
        use_switch=int(use_switch), cutoff2=kcfg["cutoff"] ** 2,
        switch_dist=kcfg["switch"] if use_switch else 0.0,
        inv_switch_width=(1.0 / (kcfg["cutoff"] - kcfg["switch"])
                          if use_switch else 0.0),
        krf=kcfg["krf"], crf=kcfg["crf"], ewald_alpha=kcfg["ewald_alpha"] or 0.0,
        elec_factor=kcfg["elec_factor"])


def kernel_cfg(cfg, clcfg, natoms, nexcl, ntypes=0, slab=None) -> CellCfg:
    ncx, ncy, ncz = clcfg.ncells
    c0, c1 = slab_cells(clcfg, slab)
    return CellCfg(natoms=natoms, capacity=clcfg.capacity, ncx=ncx, ncy=ncy,
                   ncz=ncz, nexcl=nexcl, ntypes=ntypes, cell0=c0, cell1=c1,
                   **pair_fields(cfg))


def _checked_inputs(data: CellData, cfg, clcfg, cl, pos, box, slab=None):
    """Raise on what the kernel does not take; returns (kernel cfg,
    anchored positions)."""
    from ..neighbors import anchored_positions

    if not supported_terms(cfg):
        raise NotImplementedError(
            "a cell kernel launch takes at most one of lj/repulsion/repulsioncg")
    if clcfg.capacity > MAX_CAPACITY:
        raise ValueError(f"cell capacity {clcfg.capacity} > {MAX_CAPACITY}")
    n, dev, f32, i32 = data.natoms, pos.device, torch.float32, torch.int32
    ncells = int(np.prod(clcfg.ncells))
    nexcl = int(data.excl.shape[1])
    _build.check_tensor(pos, "pos", f32, (n, 3), dev)
    _build.check_tensor(box, "box", f32, (3,), dev)
    for name in ("q", "sig", "eps"):
        _build.check_tensor(getattr(data, name), name, f32, (n,), dev)
    _build.check_tensor(data.types, "types", i32, (n,), dev)
    _build.check_tensor(data.excl, "excl", i32, (n, nexcl), dev)
    ntypes = 0
    if data.lj_a is not None:
        ntypes = int(data.lj_a.shape[0])
        _build.check_tensor(data.lj_a, "lj_a", f32, (ntypes, ntypes), dev)
        _build.check_tensor(data.lj_b, "lj_b", f32, (ntypes, ntypes), dev)
    _build.check_tensor(cl.slots, "slots", i32, (ncells, clcfg.capacity), dev)
    _build.check_tensor(cl.counts, "counts", i32, (ncells,), dev)
    pos_w = anchored_positions(pos, cl.ref_pos, box).contiguous()
    return kernel_cfg(cfg, clcfg, n, nexcl, ntypes, slab), pos_w


def _scratch(lib, kcfg, dev):
    nbytes = int(lib.tmd_cell_scratch_bytes(kcfg))
    return torch.empty(nbytes, dtype=torch.uint8, device=dev)


def _energies_out(cfg, energies, forces, with_virial):
    out = {t: energies[0] for t in LJ_FAMILY if t in cfg.terms}
    if "electrostatics" in cfg.terms:
        out["electrostatics"] = energies[1]
    if with_virial:
        # the kernel returns the raw sums over ordered pairs
        return out, forces, -0.5 * energies[2:]
    return out, forces


def _launch(data: CellData, cfg, clcfg, cl, pos, box, with_virial=False, stats=None,
            slab=None):
    global LAUNCHES, SLAB_LAUNCHES
    kcfg, pos_w = _checked_inputs(data, cfg, clcfg, cl, pos, box, slab)
    n, dev = data.natoms, pos.device
    if stats is not None:
        _build.check_tensor(stats, "stats", torch.int64, (NSTATS,), dev)
    if kcfg.cell1 == kcfg.cell0:
        # an empty slab: no i atoms
        zero = torch.zeros(5 if with_virial else 2, dtype=torch.float32, device=dev)
        return _energies_out(cfg, zero, torch.zeros((n, 3), dtype=torch.float32,
                                                    device=dev), with_virial)
    forces = torch.empty((n, 3), dtype=torch.float32, device=dev)
    energies = torch.empty(5 if with_virial else 2, dtype=torch.float32, device=dev)
    lib = _library()
    scratch = _scratch(lib, kcfg, dev)
    tables = (None, None) if data.lj_a is None else (data.lj_a.data_ptr(),
                                                     data.lj_b.data_ptr())
    err = lib.tmd_cell_energy_forces(
        pos_w.data_ptr(), data.q.data_ptr(), data.sig.data_ptr(),
        data.eps.data_ptr(), data.types.data_ptr(), cl.slots.data_ptr(),
        cl.counts.data_ptr(), data.excl.data_ptr(), *tables, box.data_ptr(), kcfg,
        int(with_virial),
        scratch.data_ptr(), forces.data_ptr(), energies.data_ptr(),
        None if stats is None else stats.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"cell kernel launch failed: {lib.tmd_error_string(err).decode()}")
    if slab is None:
        LAUNCHES += 1
    else:
        SLAB_LAUNCHES += 1
    return _energies_out(cfg, energies, forces, with_virial)


def cell_tiles(data: CellData, cfg, clcfg, cl, pos, box) -> Tiles:
    """The kernel's prep pass alone on a CUDA tensor (for tests): its packed
    rows and tile boxes, as `cell_tiles_reference` gives them (slots past
    a cell's count are not written: compare the occupied ones)."""
    kcfg, pos_w = _checked_inputs(data, cfg, clcfg, cl, pos, box)
    lib = _library()
    scratch = _scratch(lib, kcfg, pos.device)
    err = lib.tmd_cell_prep(
        pos_w.data_ptr(), data.q.data_ptr(), data.sig.data_ptr(), data.eps.data_ptr(),
        data.types.data_ptr(), cl.slots.data_ptr(), cl.counts.data_ptr(), box.data_ptr(),
        kcfg,
        scratch.data_ptr(), torch.cuda.current_stream(pos.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cell prep launch failed: {lib.tmd_error_string(err).decode()}")
    ncells, cap = int(np.prod(clcfg.ncells)), clcfg.capacity
    rows = scratch.view(torch.float32)
    slots, ntile = ncells * cap, ncells * (-(-cap // TILE))
    return Tiles(rows[:4 * slots].view(slots, 4), rows[4 * slots:8 * slots].view(slots, 4),
                 rows[8 * slots:8 * slots + 8 * ntile].view(ntile, 2, 4))


def cell_energy_forces(data: CellData, cfg, clcfg, cl, pos, box, with_virial=False,
                       stats=None, slab=None):
    """pos: (N, 3); box: (3,) diagonal tensor; `cl` a CellList built for
    `clcfg`. Returns ({term: 0-dim energy tensor}, forces (N, 3)) and, with
    `with_virial`, the per-axis pair virial (3,). A CPU tensor runs the
    plain version; a CUDA tensor launches the kernel (f32 only) or raises.
    Either runs once per LJ-family term (`over_launches`). `stats`, an
    int64 (NSTATS,) tensor on the card, gains the kernel's walk counters
    (STATS). `slab=(cx0, nloc)`: the slab's i atoms only (module
    docstring; counted in SLAB_LAUNCHES)."""
    if pos.device.type == "cuda":
        def one(c):
            return _launch(data, c, clcfg, cl, pos, box, with_virial, stats, slab)
    elif pos.device.type == "cpu":
        def one(c):
            return cell_reference(data, c, clcfg, cl, pos, box, with_virial, slab)
    else:
        raise ValueError(f"no cell kernel for device {pos.device}")
    return over_launches(cfg, one)
