"""z-sorted column neighbour structure for the large-N nonbonded path.

Counterpart of `torchmd_tpu.columns`: the static configuration, the
(re)build that produces the slot layout and the window table on the
device, and `ColumnKernel`, which has the `neighbors.CellKernel` duck type
(build / needs_rebuild / update / covers / with_box / energy_forces /
energy_forces_virial / check_overflow / grow) so the force shell and the
integrator drive either structure.

Layout produced by `build_columns` (identical to the JAX package's):

  - `islot`  (ncol, C)  int32: atoms of each (x, y) column sorted by a
    z bin (N = padding). C is a multiple of IBLK.
  - `jslot`  (ncol, CE) int32: the same atoms plus z-ghost duplicates
    (entries within cutoff + skin of a z face appear again shifted by
    +-Lz), sorted by z bin; `jzshift` carries each slot's z shift in
    units of Lz (-1, 0, +1), so a box that changes inside a chunk (the
    MTK barostat) stays exact.
  - `wstart` (ncol, 9, NB) int32: for every IBLK-wide i block and every
    3x3 neighbour column, the start (in units of 128 slots) of the
    contiguous extended-slot window of static width W that covers every
    partner within cutoff + skin in z; -1 marks an all-padding block.

Attributes (charge, LJ rows, exclusions) are read per atom by the kernel
through the slot ids (`ops.cell.CellData`), not gathered per slot. The
pair evaluation is `ops.column`: the CUDA kernel and its plain version.

Validity between rebuilds follows the skin/2 displacement criterion of
the cell path; evaluation positions are anchored to the build frame
(`neighbors.anchored_positions`). The TPU-only phase replicas
(`TMD_COL_PHASES`, P > 1) are not ported: P = 1.
"""

from __future__ import annotations

import copy
from typing import NamedTuple

import numpy as np
import torch

from .neighbors import build_exclusion_table, displacement_trigger

# i-block rows per window lookup. It defines the state's layout (C rounds
# up to it, one window per i block), so it equals the JAX package's
# TMD_COL_IBLK default. Provisional: tuned on a TPU, not yet on the H100.
IBLK = 48
STRIDE = 128   # window starts are 128-slot granular (P = 1)


class ColumnConfig(NamedTuple):
    box: tuple          # concrete (lx, ly, lz)
    cutoff: float
    skin: float
    ncols: tuple        # (ncx, ncy)
    C: int              # main column capacity (multiple of IBLK)
    CE: int             # ghost-extended capacity (multiple of 128, >= W)
    W: int              # window width (multiple of 128)
    IBLK: int = IBLK
    nbins: int = 512    # z-bin resolution for the sort and the windows
    nexcl: int = 0      # exclusion-list width

    @property
    def rc(self):
        return self.cutoff + self.skin

    @property
    def NB(self):
        return self.C // self.IBLK

    @property
    def ncol(self):
        return self.ncols[0] * self.ncols[1]


def _round_up(n, m: int) -> int:
    return -(-int(n) // m) * m


def column_grid_feasible(box, cutoff, skin=2.0) -> bool:
    b = np.asarray(box, np.float64).reshape(-1)[:3]
    if not np.all(b > 0):
        return False
    rc = float(cutoff) + float(skin)
    return bool(b[0] // rc >= 3 and b[1] // rc >= 3 and b[2] >= 2 * rc)


def make_column_config(box, cutoff, skin=2.0, pos0=None, natoms=None,
                       nexcl=0, IBLK=IBLK, nbins=512) -> ColumnConfig:
    """The static column configuration. `pos0` sizes the capacities and
    the window width from the real starting occupancy; without it a
    uniform-density estimate is used. The overflow grow-and-retry covers
    later density fluctuations."""
    box = tuple(float(b) for b in np.asarray(box).reshape(-1)[:3])
    if not column_grid_feasible(box, cutoff, skin):
        raise ValueError(
            f"Box {box} cannot host a 3x3 column grid with rc={cutoff + skin}")
    rc = float(cutoff) + float(skin)
    ncx = max(3, int(box[0] // rc))
    ncy = max(3, int(box[1] // rc))
    cfg = ColumnConfig(box, float(cutoff), float(skin), (ncx, ncy),
                       IBLK, 128, 128, IBLK, nbins, int(nexcl))
    if pos0 is not None:
        pos0 = np.asarray(pos0, np.float64).reshape(-1, 3)
        occ, occ_e, wneed = _occupancy_probe(pos0, cfg)
        C = _round_up(max(IBLK, occ * 1.15 + 8), IBLK)
        CE = _round_up(max(128, occ_e * 1.12 + 8), 128)
        W = _round_up(max(128, wneed * 1.15 + 8 + STRIDE - 1), 128)
    else:
        n = natoms or 1000
        dens = n / (box[0] * box[1] * box[2])
        col = dens * (box[0] / ncx) * (box[1] / ncy) * box[2]
        C = _round_up(max(IBLK, col * 1.2 + 4 * np.sqrt(max(col, 1.0))), IBLK)
        CE = _round_up(C * (1.0 + 2 * rc / box[2]) + 8, 128)
        zfrac = (2 * rc + IBLK / max(col / box[2], 1e-9)) / (box[2] + 2 * rc)
        W = _round_up(max(128, CE * min(zfrac, 1.0) + 4 * np.sqrt(max(col, 1.0))
                          + 127), 128)
    CE = max(CE, W)
    return cfg._replace(C=int(C), CE=int(CE), W=int(W))


def _occupancy_probe(pos0, cfg: ColumnConfig):
    """Host-side numpy probe of the largest column occupancy, extended
    occupancy and window need of a starting configuration, counted on the
    same z bins as the device build."""
    b = np.asarray(cfg.box)
    rc = cfg.rc
    ncx, ncy = cfg.ncols
    p = pos0 - b * np.floor(pos0 / b)
    cx = np.clip((p[:, 0] / b[0] * ncx).astype(int), 0, ncx - 1)
    cy = np.clip((p[:, 1] / b[1] * ncy).astype(int), 0, ncy - 1)
    col = cx * ncy + cy
    z = p[:, 2]
    occ = np.bincount(col, minlength=cfg.ncol).max() if len(col) else 1
    ghost_hi = z < rc
    ghost_lo = z > b[2] - rc
    cole = np.concatenate([col, col[ghost_hi], col[ghost_lo]])
    ze = np.concatenate([z, z[ghost_hi] + b[2], z[ghost_lo] - b[2]])
    occ_e = np.bincount(cole, minlength=cfg.ncol).max() if len(cole) else 1
    wneed = 1
    span = b[2] + 2 * rc
    binw = span / cfg.nbins
    zbin_e = np.clip(((ze + rc) / span * cfg.nbins).astype(int), 0, cfg.nbins - 1)
    bins_by_col = [np.sort(zbin_e[cole == c]) for c in range(cfg.ncol)]
    nbr = column_neighbor_table(cfg)
    for c in range(cfg.ncol):
        zc = np.sort(z[col == c])
        for s in range(0, len(zc), cfg.IBLK):
            chunk = zc[s:s + cfg.IBLK]
            lo, hi = chunk[0] - binw - rc, chunk[-1] + binw + rc
            lob = int(np.clip((lo + rc) / span * cfg.nbins, 0, cfg.nbins - 1))
            hib = int(np.clip((hi + rc) / span * cfg.nbins, 0, cfg.nbins - 1))
            for c2 in nbr[c]:
                arr = bins_by_col[c2]
                need = (np.searchsorted(arr, hib, side="right")
                        - np.searchsorted(arr, lob, side="left"))
                wneed = max(wneed, int(need))
    return int(occ), int(occ_e), int(wneed)


def _stencil(cfg: ColumnConfig):
    ncx, ncy = cfg.ncols
    cx, cy = np.meshgrid(np.arange(ncx), np.arange(ncy), indexing="ij")
    cx, cy = cx.ravel()[:, None], cy.ravel()[:, None]
    offs = np.array([(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)])
    return cx + offs[None, :, 0], cy + offs[None, :, 1]


def column_neighbor_table(cfg: ColumnConfig) -> np.ndarray:
    """(ncol, 9) table of the 3x3 neighbour column ids (periodic), offset
    o9 = (dx + 1) * 3 + (dy + 1)."""
    ncx, ncy = cfg.ncols
    tx, ty = _stencil(cfg)
    return ((tx % ncx) * ncy + ty % ncy).astype(np.int32)


def column_shift_table(cfg: ColumnConfig) -> np.ndarray:
    """(ncol, 9, 2) x/y wrap unit counts (-1/0/+1) of the neighbour
    columns; the evaluation multiplies them by the current box."""
    ncx, ncy = cfg.ncols
    tx, ty = _stencil(cfg)
    sx = np.where(tx < 0, -1.0, np.where(tx >= ncx, 1.0, 0.0))
    sy = np.where(ty < 0, -1.0, np.where(ty >= ncy, 1.0, 0.0))
    return np.stack([sx, sy], axis=-1).astype(np.float32)


class ColumnState(NamedTuple):
    islot: torch.Tensor     # (ncol, C) int32, N = padding
    jslot: torch.Tensor     # (ncol, CE) int32, N = padding
    jzshift: torch.Tensor   # (ncol, CE) z shift in units of Lz, pos dtype
    wstart: torch.Tensor    # (ncol, 9, NB) int32, in 128-slot units; -1 = skip
    ref_pos: torch.Tensor   # (N, 3) build-time positions
    overflow: torch.Tensor  # bool scalar (capacity or window overflow)


def _zbin(z, rc, span, nbins):
    """Bin of each z on the extended span [-rc, Lz + rc), clamped. The
    clamp before the integer conversion only keeps far-out sentinels in
    range; the bin is the JAX package's truncation."""
    u = torch.clamp((z + rc) / span * nbins, -1.0, float(nbins))
    return torch.clamp(u.to(torch.int32), 0, nbins - 1)


def build_columns(pos, cfg: ColumnConfig, box=None) -> ColumnState:
    """Sort, slot and window `pos` (N, 3) on its device: one stable sort
    per side on the key col * nbins + zbin, slot tables gathered from the
    contiguous runs, window starts from `searchsorted` into the sorted
    keys. No host synchronisation."""
    n = pos.shape[0]
    dev, dt = pos.device, pos.dtype
    i32 = torch.int32
    b = torch.as_tensor(cfg.box if box is None else box, dtype=dt, device=dev).reshape(3)
    rc = cfg.rc
    ncx, ncy = cfg.ncols
    ncol, C, CE, W, NB, nbins = cfg.ncol, cfg.C, cfg.CE, cfg.W, cfg.NB, cfg.nbins
    span = b[2] + 2 * rc
    binw = span / nbins

    pos_w = pos - b * torch.floor(pos / b)
    x, y, z = pos_w[:, 0], pos_w[:, 1], pos_w[:, 2]
    cx = torch.clamp((x / b[0] * ncx).to(i32), 0, ncx - 1)
    cy = torch.clamp((y / b[1] * ncy).to(i32), 0, ncy - 1)
    col = (cx * ncy + cy).long()
    col_edges = torch.arange(ncol + 1, device=dev) * nbins

    def slot_table(key, nent, cap):
        """Sorted keys, sort order, run starts and counts per column, and
        the (ncol, cap) table of entry ids (nent = padding)."""
        key_s, order = torch.sort(key, stable=True)
        starts = torch.searchsorted(key_s, col_edges)
        cnt = starts[1:] - starts[:-1]
        ar = torch.arange(cap, device=dev)
        slotpos = starts[:-1, None] + ar
        valid = ar[None, :] < torch.clamp(cnt, max=cap)[:, None]
        order_pad = torch.cat([order, order.new_full((1,), nent)])
        ids = torch.where(valid, order_pad[torch.clamp(slotpos, max=nent)],
                          torch.full_like(slotpos, nent))
        return key_s, order, starts, cnt, ids

    # i side
    key_i = col * nbins + _zbin(z, rc, span, nbins).long()
    _, order_i, starts_i, cnt_i, islot = slot_table(key_i, n, C)
    z_is = z[order_i]
    overflow = (cnt_i > C).any()

    # j side: the atoms plus their z-ghost duplicates; entry k < n is the
    # atom, [n, 2n) its +Lz copy, [2n, 3n) its -Lz copy, 3n padding
    none = torch.full_like(col, ncol)
    colj = torch.cat([col, torch.where(z < rc, col, none),
                      torch.where(z > b[2] - rc, col, none)])
    zj = torch.cat([z, z + b[2], z - b[2]])
    key_j = colj * nbins + _zbin(zj, rc, span, nbins).long()
    key_js, _, starts_j, cnt_j, g = slot_table(key_j, 3 * n, CE)
    overflow = overflow | (cnt_j > CE).any()
    jslot = torch.where(g < 3 * n, g % n, torch.full_like(g, n))
    jzshift = torch.where(g < n, 0.0, torch.where(g < 2 * n, 1.0, torch.where(
        g < 3 * n, -1.0, 0.0))).to(dt)

    # i blocks: contiguous IBLK runs of the sorted i side; z ascends in a
    # column up to one bin, so a block spans [z(first) - binw, z(last) + binw]
    ends = starts_i[:-1] + torch.clamp(cnt_i, max=C)
    blk0 = starts_i[:-1, None] + torch.arange(NB, device=dev)[None, :] * cfg.IBLK
    block_valid = blk0 < ends[:, None]
    blk_last = torch.clamp(torch.minimum(blk0 + cfg.IBLK, ends[:, None]) - 1, 0, n - 1)
    big = torch.full((1,), float(np.finfo(np.float32).max / 4), dtype=dt, device=dev)
    z_is_pad = torch.cat([z_is, big])
    lob = _zbin(z_is_pad[torch.clamp(blk0, max=n)] - binw - rc, rc, span, nbins).long()
    hib = _zbin(z_is_pad[blk_last] + binw + rc, rc, span, nbins).long()
    nbr = torch.as_tensor(column_neighbor_table(cfg), dtype=torch.long, device=dev)
    q_start = nbr[:, :, None] * nbins + lob[:, None, :]
    q_end = nbr[:, :, None] * nbins + hib[:, None, :] + 1
    start_g = torch.searchsorted(key_js, q_start.reshape(-1)).reshape(ncol, 9, NB)
    end_g = torch.searchsorted(key_js, q_end.reshape(-1)).reshape(ncol, 9, NB)
    col_base = starts_j[:-1][nbr][:, :, None]
    startq = torch.div(start_g - col_base, STRIDE, rounding_mode="floor")
    overflow = overflow | (block_valid[:, None, :]
                           & ((end_g - col_base - startq * STRIDE) > W)).any()
    # CE and W are multiples of 128: a clamped window still ends at CE
    startq = torch.clamp(startq, max=(CE - W) // STRIDE)
    wstart = torch.where(block_valid[:, None, :], startq, torch.full_like(startq, -1))
    return ColumnState(islot.to(i32), jslot.to(i32), jzshift, wstart.to(i32),
                       pos, overflow)


def column_needs_rebuild(st: ColumnState, pos, cfg: ColumnConfig, box=None):
    """True (a bool tensor) once the structure may miss a cutoff pair."""
    d = pos - st.ref_pos
    b = torch.as_tensor(cfg.box if box is None else box, dtype=pos.dtype,
                        device=pos.device).reshape(3)
    d = d - b * torch.round(d / b)
    return displacement_trigger((d * d).sum(1), cfg.skin)


def column_supported(cfg, ffp, box, skin=2.0) -> bool:
    """Can the column kernel serve this system? A feasible 3x3 column
    grid, Lorentz-Berthelot LJ (no NBFIX tables) and the pair kernels'
    term set (one LJ-family term)."""
    from .ops.nonbonded import supported_terms

    return (cfg.cutoff is not None and box is not None and ffp.lj_ab is None
            and supported_terms(cfg) and column_grid_feasible(box, cfg.cutoff, skin))


class ColumnKernel:
    """Large-N nonbonded kernel on the z-sorted column structure, with the
    `neighbors.CellKernel` duck type.

        st = kern.build(pos, box)
        pot, forces = kern.energy_forces(pos, box, st)
        pot, forces, virial = kern.energy_forces_virial(pos, box, st)

    On a CUDA tensor the evaluation launches the column kernel
    (`ops.column`); on a CPU tensor, or with `plain=True` on any device,
    it runs the plain version."""

    capacity_name = "column capacities (slots per column)"

    def __init__(self, ffp, cfg, parameters, box, skin=2.0,
                 exclusions=("bonds", "angles", "1-4"), pos0=None, plain=False):
        from .ops.cell import prepare_cell_data

        if cfg.cutoff is None:
            raise ValueError("Column lists require a cutoff")
        natoms = int(ffp.charges.shape[0])
        self.ffp = ffp
        self.cfg = cfg
        self.plain = plain
        self.excl_table = build_exclusion_table(parameters, natoms, exclusions)
        self.data = prepare_cell_data(ffp, self.excl_table)
        self.ccfg = make_column_config(box, cfg.cutoff, skin=skin, pos0=pos0,
                                       natoms=natoms, nexcl=int(self.excl_table.shape[1]))

    @property
    def clcfg(self):
        return self.ccfg

    def build(self, pos, box=None) -> ColumnState:
        return build_columns(pos, self.ccfg, box)

    def needs_rebuild(self, st: ColumnState, pos, box=None):
        return column_needs_rebuild(st, pos, self.ccfg, box)

    def refresh(self, st, pos, box=None) -> ColumnState:
        """The structure for `pos`: rebuilt at every call, on the device."""
        return self.build(pos, box)

    def covers(self, box) -> bool:
        """True while the box still hosts rc-wide columns and a 2 rc-tall
        z extent (binning follows the current box)."""
        b = np.asarray(box, np.float64).reshape(-1, 3).min(axis=0)
        rc = self.ccfg.rc
        return bool(b[0] / self.ccfg.ncols[0] >= rc * (1 - 1e-9)
                    and b[1] / self.ccfg.ncols[1] >= rc * (1 - 1e-9)
                    and b[2] >= 2 * rc * (1 - 1e-9))

    def with_box(self, box, pos0=None):
        """New kernel for a materially different box (same topology)."""
        new = copy.copy(self)
        new.ccfg = make_column_config(
            box, self.cfg.cutoff, skin=self.ccfg.skin, pos0=pos0,
            natoms=int(self.ffp.charges.shape[0]), nexcl=self.ccfg.nexcl,
            IBLK=self.ccfg.IBLK)
        return new

    def _evaluate(self, pos, box, st, with_virial):
        from .ops import column as _ops_column

        fn = _ops_column.column_reference if self.plain else _ops_column.column_energy_forces
        return fn(self.data, self.cfg, self.ccfg, st, pos, box, with_virial)

    def spread_order(self, st: ColumnState):
        """The atoms in space order for the PME spread: the columns' i
        slots, z-sorted (each atom once; natoms = padding)."""
        return st.islot

    def energy_forces(self, pos, box, st: ColumnState):
        return self._evaluate(pos, box, st, False)

    def energy_forces_virial(self, pos, box, st: ColumnState):
        """(pot, forces, per-axis pair virial (3,)): -dE/ds_a of
        E(s pos, s box) for the pair terms (the MTK barostat's)."""
        return self._evaluate(pos, box, st, True)

    def check_overflow(self, st: ColumnState) -> bool:
        return bool(st.overflow)

    def grow(self) -> "ColumnKernel":
        new = copy.copy(self)
        c = self.ccfg
        W = c.W + 128
        new.ccfg = c._replace(C=_round_up(c.C * 3 // 2, c.IBLK),
                              CE=max(_round_up(c.CE * 3 // 2, 128), W), W=W)
        return new
