"""Column-pair nonbonded energy, forces and virial: the CUDA column kernel,
its plain PyTorch version, and the wrapper that picks between them by
device.

Counterpart of `torchmd_tpu/ops/pallas_column.py` (`column_pair_call`)
together with its caller `columns.column_energy_forces`, whose contract it
computes on a `columns.ColumnState`:

  - for every column c, i block bi (IBLK consecutive i slots) and offset
    o9 of the half stencil, the pairs of the block's atoms with the W
    extended j slots of column cj = neighbour(c, o9) starting at slot
    128 * wstart[c, o9, bi] (a block with wstart < 0 is all padding);
  - j positions carry the z-ghost shift jzshift * Lz and the x/y wrap of
    the neighbour column, both scaled by the current box;
  - a pair counts when both ids are below N, i != j, j is not in i's
    exclusion list and d^2 < cutoff^2;
  - the self offset (o9 = 4) visits each pair from both sides and carries
    weight 1 on the 0.5-weighted energies and i-side forces only; the four
    directed offsets (o9 = 5..8) visit each pair of two columns once,
    carry weight 2, and put the j-side force on the j atom;
  - the per-axis virial is -0.5 times the weighted sum of g d_a^2, with
    g = (dE/dr)/r: -dE/ds_a of E(s pos, s box).

The pair terms are those of the other pair kernels (LJ with the switch,
repulsion or repulsioncg, Coulomb plain / reaction field / Ewald erfc),
Lorentz-Berthelot only. `column_energy_forces(...)` runs the plain version
for a CPU tensor and launches the kernel (`csrc/column.cu`) for a CUDA
tensor; on a CUDA tensor it launches or raises. The kernel computes the
same sum over the whole 3x3 stencil (every ordered pair once, energies
at 1/2, no j-side forces) on 32-slot tiles (`csrc/tile_pairs.cuh`); its
prep pass packs the extended slots with a bounding box per tile, and
`column_tiles_reference` is that pass's plain version.
"""

from __future__ import annotations

import ctypes

import torch

from ..potentials import LJ_FAMILY, add_energy, pair_block_terms
from ..units import ELEC_FACTOR
from . import _build
from .cell import NSTATS, TILE, Tiles, pack_rows, pair_fields, tile_boxes
from .nonbonded import supported_terms

# Kernel launches made by `column_energy_forces` (one per call on CUDA).
LAUNCHES = 0

SELF_O9 = 4              # the half stencil: o9 = 4 (self) and 5..8 (directed)
HALF_STENCIL = (4, 5, 6, 7, 8)
STRIDE = 128             # window starts are in units of 128 slots
REFERENCE_PAIRS = 1 << 23  # pair slots per chunk of the plain version


# ----------------------------------------------------------------------
# Plain PyTorch version
# ----------------------------------------------------------------------

def column_reference(data, cfg, ccfg, st, pos, box, with_virial=False):
    """Plain PyTorch version of the column kernel, at the dtype and on the
    device of `pos`: each half-stencil offset in turn, the (IBLK, W) slot
    blocks of a few columns at a time; the pairs that count (ids, the
    exclusions, the cutoff) go through the port's `pair_block_terms`.
    Returns ({term: energy}, forces (N, 3)[, virial (3,)])."""
    from ..columns import column_neighbor_table, column_shift_table
    from ..neighbors import anchored_positions

    n, dt, dev = data.natoms, pos.dtype, pos.device
    ncol, W, NB, IBLK = ccfg.ncol, ccfg.W, ccfg.NB, ccfg.IBLK
    box = torch.as_tensor(box, dtype=dt, device=dev).reshape(3)
    pad3 = torch.zeros((1, 3), dtype=dt, device=dev)
    pos_e = torch.cat([anchored_positions(pos, st.ref_pos.to(dt), box), pad3])
    islot, jslot = st.islot.long(), st.jslot.long()
    Pi = pos_e[islot].reshape(ncol, NB, IBLK, 1, 3)
    Pj = pos_e[jslot]
    Pj = torch.cat([Pj[..., :2], (Pj[..., 2] + st.jzshift.to(dt) * box[2])[..., None]], -1)

    def rows(a, fill):
        return torch.cat([a, torch.full_like(a[:1], fill)])

    q = rows(data.q.to(dt), 0.0)
    sig, eps = rows(data.sig.to(dt), 0.0), rows(data.eps.to(dt), 0.0)
    excl = rows(data.excl.long(), n)
    want_lj = any(t in cfg.terms for t in LJ_FAMILY)
    want_el = "electrostatics" in cfg.terms
    nbr = torch.as_tensor(column_neighbor_table(ccfg), dtype=torch.long, device=dev)
    shifts = torch.as_tensor(column_shift_table(ccfg), dtype=dt, device=dev) * box[:2]
    win = torch.arange(W, device=dev)
    per_col = NB * IBLK * W
    chunk = max(1, REFERENCE_PAIRS // per_col)

    pot: dict = {}
    forces = torch.zeros((n + 1, 3), dtype=dt, device=dev)
    vir = torch.zeros(3, dtype=dt, device=dev)
    for o9 in HALF_STENCIL:
        weight = 1.0 if o9 == SELF_O9 else 2.0
        for c0 in range(0, ncol, chunk):
            cs = torch.arange(c0, min(ncol, c0 + chunk), device=dev)
            k = cs.shape[0]
            cj = nbr[cs, o9]
            ws = st.wstart[cs, o9, :].long()                      # (k, NB)
            jw = (torch.clamp(ws, min=0) * STRIDE)[..., None] + win  # (k, NB, W)
            idj = jslot[cj[:, None, None], jw]                     # (k, NB, W)
            Pw = Pj[cj[:, None, None], jw]
            Pw = torch.cat([Pw[..., :2] + shifts[cs, o9][:, None, None, :], Pw[..., 2:]], -1)
            dv = (Pi[cs] - Pw[:, :, None, :, :]).reshape(-1, W, 3)
            idi = islot[cs].reshape(k, NB, IBLK, 1)
            idw = idj[:, :, None, :]
            mask = ((idi < n) & (idw < n) & (idi != idw)
                    & (ws >= 0)[:, :, None, None])
            if excl.shape[1]:
                mask = mask & ~(excl[idi] == idw[..., None]).any(-1)
            mask = mask.reshape(-1, W) & ((dv * dv).sum(-1) <= cfg.cutoff ** 2)
            # the pairs that count, as a (P, 1) block
            row, col = mask.nonzero(as_tuple=True)
            ai = islot[cs].reshape(-1)[row]
            aj = idj.reshape(k * NB, W)[row // IBLK, col]
            dvp = dv[row, col][:, None, :]
            qq = A = B = None
            if want_el:
                qq = (ELEC_FACTOR * q[ai] * q[aj])[:, None]
            if want_lj:
                s6 = ((sig[ai] + sig[aj]) ** 6)[:, None]
                B = 4.0 * (eps[ai] * eps[aj])[:, None] * s6
                A = B * s6
            out, g = pair_block_terms(cfg, dvp, torch.ones_like(dvp[..., 0], dtype=torch.bool),
                                      qq, A, B)
            for key, v in out.items():
                add_energy(pot, key, weight * v)
            gdv = g * dvp[:, 0, :]
            forces.index_add_(0, ai, -gdv)
            if o9 != SELF_O9:
                forces.index_add_(0, aj, gdv)
            if with_virial:
                vir = vir + weight * (gdv * dvp[:, 0, :]).sum(0)
    if with_virial:
        return pot, forces[:n], -0.5 * vir
    return pot, forces[:n]


def column_tiles_reference(data, st, pos_w, box) -> Tiles:
    """Plain version of the column kernel's prep pass on anchored f32
    positions `pos_w`: every extended slot (ncol x CE, in order) packed
    with its z ghost shift times the box added (padding at FAR), and the
    box of each TILE consecutive slots."""
    ids = st.jslot.reshape(-1).long()
    valid = ids < data.natoms
    pos = torch.cat([pos_w.float(), torch.zeros_like(pos_w[:1]).float()])
    xyz = pos[ids].clone()
    xyz[:, 2] = xyz[:, 2] + st.jzshift.reshape(-1).float() * box.float()[2]
    pq, aux = pack_rows(xyz, ids, valid, data.q, data.sig, data.eps, data.natoms)
    return Tiles(pq, aux, tile_boxes(pq[:, :3], valid))


# ----------------------------------------------------------------------
# CUDA kernel
# ----------------------------------------------------------------------

class ColumnCfg(ctypes.Structure):
    """Mirror of `struct ColumnCfg` in csrc/column.cu."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "natoms", "ncx", "ncy", "C", "CE", "W", "NB", "iblk", "nexcl",
        "lj_kind", "elec_kind", "use_switch")] + [(name, ctypes.c_float) for name in (
            "cutoff2", "switch_dist", "inv_switch_width", "krf", "crf",
            "ewald_alpha", "elec_factor")]


_P = ctypes.c_void_p
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("column")
        lib.tmd_column_energy_forces.argtypes = ([_P] * 10 + [ColumnCfg, ctypes.c_int]
                                                 + [_P] * 5)
        lib.tmd_column_energy_forces.restype = ctypes.c_int
        lib.tmd_column_prep.argtypes = [_P] * 7 + [ColumnCfg] + [_P] * 2
        lib.tmd_column_prep.restype = ctypes.c_int
        lib.tmd_column_scratch_bytes.argtypes = [ColumnCfg]
        lib.tmd_column_scratch_bytes.restype = ctypes.c_longlong
        lib.tmd_error_string.argtypes = [ctypes.c_int]
        lib.tmd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def build():
    """Compile and load the kernel library (done at first launch anyway)."""
    _library()


def kernel_cfg(cfg, ccfg, natoms, nexcl) -> ColumnCfg:
    return ColumnCfg(
        natoms=natoms, ncx=ccfg.ncols[0], ncy=ccfg.ncols[1], C=ccfg.C, CE=ccfg.CE,
        W=ccfg.W, NB=ccfg.NB, iblk=ccfg.IBLK, nexcl=nexcl, **pair_fields(cfg))


def _checked_inputs(data, cfg, ccfg, st, pos, box):
    """Raise on what the kernel does not take; returns (kernel cfg,
    anchored positions)."""
    from ..neighbors import anchored_positions

    if not supported_terms(cfg):
        raise NotImplementedError(
            "the column kernel takes at most one of lj/repulsion/repulsioncg")
    if data.lj_a is not None:
        raise NotImplementedError(
            "the column kernel takes Lorentz-Berthelot rows, not NBFIX tables")
    if ccfg.W % STRIDE or ccfg.W < STRIDE or ccfg.CE % STRIDE:
        raise ValueError(f"column layout W={ccfg.W}, CE={ccfg.CE} not supported")
    n, dev, f32, i32 = data.natoms, pos.device, torch.float32, torch.int32
    ncol, nexcl = ccfg.ncol, int(data.excl.shape[1])
    _build.check_tensor(pos, "pos", f32, (n, 3), dev)
    _build.check_tensor(box, "box", f32, (3,), dev)
    for name in ("q", "sig", "eps"):
        _build.check_tensor(getattr(data, name), name, f32, (n,), dev)
    _build.check_tensor(data.excl, "excl", i32, (n, nexcl), dev)
    _build.check_tensor(st.islot, "islot", i32, (ncol, ccfg.C), dev)
    _build.check_tensor(st.jslot, "jslot", i32, (ncol, ccfg.CE), dev)
    _build.check_tensor(st.jzshift, "jzshift", f32, (ncol, ccfg.CE), dev)
    _build.check_tensor(st.wstart, "wstart", i32, (ncol, 9, ccfg.NB), dev)
    pos_w = anchored_positions(pos, st.ref_pos, box).contiguous()
    return kernel_cfg(cfg, ccfg, n, nexcl), pos_w


def _scratch(lib, kcfg, dev):
    nbytes = int(lib.tmd_column_scratch_bytes(kcfg))
    return torch.empty(nbytes, dtype=torch.uint8, device=dev)


def _launch(data, cfg, ccfg, st, pos, box, with_virial=False, stats=None):
    global LAUNCHES
    kcfg, pos_w = _checked_inputs(data, cfg, ccfg, st, pos, box)
    n, dev = data.natoms, pos.device
    if stats is not None:
        _build.check_tensor(stats, "stats", torch.int64, (NSTATS,), dev)
    forces = torch.empty((n, 3), dtype=torch.float32, device=dev)
    out = torch.empty(5, dtype=torch.float32, device=dev)
    lib = _library()
    scratch = _scratch(lib, kcfg, dev)
    err = lib.tmd_column_energy_forces(
        pos_w.data_ptr(), data.q.data_ptr(), data.sig.data_ptr(), data.eps.data_ptr(),
        data.excl.data_ptr(), st.islot.data_ptr(), st.jslot.data_ptr(),
        st.jzshift.data_ptr(), st.wstart.data_ptr(), box.data_ptr(), kcfg,
        int(with_virial), scratch.data_ptr(), forces.data_ptr(), out.data_ptr(),
        None if stats is None else stats.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"column kernel launch failed: {lib.tmd_error_string(err).decode()}")
    LAUNCHES += 1
    pot = {t: out[0] for t in LJ_FAMILY if t in cfg.terms}
    if "electrostatics" in cfg.terms:
        pot["electrostatics"] = out[1]
    if with_virial:
        # the kernel returns the weighted raw sums of g d_a^2
        return pot, forces, -0.5 * out[2:]
    return pot, forces


def column_tiles(data, cfg, ccfg, st, pos, box) -> Tiles:
    """The kernel's prep pass alone on a CUDA tensor (for tests): its packed
    rows and j tile boxes, as `column_tiles_reference` gives them."""
    kcfg, pos_w = _checked_inputs(data, cfg, ccfg, st, pos, box)
    lib = _library()
    scratch = _scratch(lib, kcfg, pos.device)
    err = lib.tmd_column_prep(
        pos_w.data_ptr(), data.q.data_ptr(), data.sig.data_ptr(), data.eps.data_ptr(),
        st.jslot.data_ptr(), st.jzshift.data_ptr(), box.data_ptr(), kcfg,
        scratch.data_ptr(), torch.cuda.current_stream(pos.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"column prep launch failed: {lib.tmd_error_string(err).decode()}")
    rows = scratch.view(torch.float32)
    slots = ccfg.ncol * ccfg.CE
    ntile = slots // TILE
    return Tiles(rows[:4 * slots].view(slots, 4), rows[4 * slots:8 * slots].view(slots, 4),
                 rows[8 * slots:8 * slots + 8 * ntile].view(ntile, 2, 4))


def column_energy_forces(data, cfg, ccfg, st, pos, box, with_virial=False, stats=None):
    """pos: (N, 3); box: (3,) diagonal tensor; `st` a ColumnState built for
    `ccfg`; `data` the per-atom rows of `ops.cell.prepare_cell_data`.
    Returns ({term: 0-dim energy tensor}, forces (N, 3)) and, with
    `with_virial`, the per-axis pair virial (3,). A CPU tensor runs the
    plain version; a CUDA tensor launches the kernel (f32 only) or
    raises. `stats`, an int64 (NSTATS,) tensor on the card, gains the
    kernel's walk counters (`ops.cell.STATS`)."""
    if pos.device.type == "cuda":
        return _launch(data, cfg, ccfg, st, pos, box, with_virial, stats)
    if pos.device.type == "cpu":
        return column_reference(data, cfg, ccfg, st, pos, box, with_virial)
    raise ValueError(f"no column kernel for device {pos.device}")


def window_slot_pairs(ccfg, st) -> int:
    """Slot pairs the layout's half-stencil windows hold: IBLK x W per
    valid (column, offset, block) window (the walk before any culling)."""
    valid = int((st.wstart[:, list(HALF_STENCIL), :] >= 0).sum())
    return valid * ccfg.IBLK * ccfg.W
