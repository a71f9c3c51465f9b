"""Cell lists for O(N) nonbonded evaluation of periodic systems.

Counterpart of the cell-list part of `torchmd_tpu.neighbors`:

  - the box is partitioned into cells of edge >= cutoff + skin (grid
    resolution fixed at construction from the concrete box);
  - atoms scatter into (ncells, capacity) slots by rank within their cell
    (sort by cell id; rank = position - first occurrence), on the device;
    slots of a cell are filled from 0, so slot k < count holds an atom;
  - pair evaluation for the atoms of a cell runs over the 27 neighbouring
    cells' slots, with periodic images applied as a per-neighbour-cell
    shift, exclusions checked against a padded per-atom exclusion list and
    the cutoff applied as a mask.

Positions are anchored to the build frame (`anchored_positions`): each
atom stays spatially continuous with the cell it was binned into, so the
per-cell image shift is exact between rebuilds. A cell holding more atoms
than the capacity sets a sticky overflow flag; the caller grows the
capacity (`CellKernel.grow`) and redoes the work.

`cell_nonbonded_energy_forces` is the JAX package's function signature;
the evaluation itself is `ops.cell`: the CUDA kernel, and its plain
PyTorch version which this function runs. Orthorhombic boxes only.
"""

from __future__ import annotations

import copy
from typing import NamedTuple

import numpy as np
import torch


class CellListConfig(NamedTuple):
    box: tuple            # concrete (lx, ly, lz)
    cutoff: float
    skin: float
    ncells: tuple         # (ncx, ncy, ncz); cell edges >= cutoff + skin
    capacity: int

    @property
    def rc(self):
        return self.cutoff + self.skin

    def with_capacity(self, capacity: int) -> "CellListConfig":
        return self._replace(capacity=capacity)


def make_cell_config(box, cutoff, skin=2.0, capacity=None,
                     natoms=None) -> CellListConfig:
    """Cell grid for a concrete box: the 27-cell stencil with cell edges
    >= cutoff + skin, so at least 3 cells per axis."""
    box = tuple(float(b) for b in np.asarray(box).reshape(-1)[:3])
    if min(box) <= 0:
        raise ValueError("Cell lists require a periodic box")
    rc = cutoff + skin
    nc = tuple(max(1, int(b // rc)) for b in box)
    if min(nc) < 3:
        raise ValueError(
            f"Box {box} too small for a cell list with rc={rc}; use the dense path")
    if capacity is None:
        # Poisson-ish occupancy slack; the overflow-growth machinery covers
        # outliers, so a tight factor wins (pair work scales with cap^2)
        density = (natoms or 1000) / (nc[0] * nc[1] * nc[2])
        capacity = int(max(4, np.ceil(density * 1.7 + 4.0 * np.sqrt(density))))
    return CellListConfig(box, float(cutoff), float(skin), nc, capacity)


class CellList(NamedTuple):
    slots: torch.Tensor     # (ncells, capacity) int32 atom ids, natoms = empty
    counts: torch.Tensor    # (ncells,) int32 atoms binned per cell
    ref_pos: torch.Tensor   # positions at build time
    overflow: torch.Tensor  # bool scalar


def _box_tensor(box, cfg, like):
    return torch.as_tensor(cfg.box if box is None else box, dtype=like.dtype,
                           device=like.device).reshape(3)


def _cell_ids(pos, cfg: CellListConfig, box=None):
    """Cell id of each atom: the grid resolution is static, the binning box
    may be given per call."""
    box = _box_tensor(box, cfg, pos)
    frac = pos / box
    frac = frac - torch.floor(frac)  # wrap into [0, 1)
    nc = torch.as_tensor(cfg.ncells, device=pos.device)
    cid3 = torch.minimum(
        (frac * nc.to(pos.dtype)).to(torch.int64), nc - 1)
    return (cid3[:, 0] * cfg.ncells[1] + cid3[:, 1]) * cfg.ncells[2] + cid3[:, 2]


def build_cell_list(pos, cfg: CellListConfig, box=None) -> CellList:
    """Bin `pos` (natoms, 3) into the slot table, on the device of `pos`."""
    n = pos.shape[0]
    ncells = cfg.ncells[0] * cfg.ncells[1] * cfg.ncells[2]
    cid = _cell_ids(pos, cfg, box)
    sorted_cid, order = torch.sort(cid, stable=True)
    first = torch.searchsorted(sorted_cid, sorted_cid, side="left")
    rank = torch.arange(n, device=pos.device) - first
    overflow = (rank >= cfg.capacity).any()
    rank = torch.clamp(rank, max=cfg.capacity - 1)
    slots = torch.full((ncells, cfg.capacity), n, dtype=torch.int32,
                       device=pos.device)
    slots[sorted_cid, rank] = order.to(torch.int32)
    # index_add_, not bincount: bincount on CUDA reads its size back to the
    # host, a synchronisation in every step
    counts = torch.zeros(ncells, dtype=torch.int32, device=pos.device).index_add_(
        0, cid, torch.ones_like(cid, dtype=torch.int32))
    return CellList(slots, counts, pos, overflow)


def anchored_positions(pos, ref, box):
    """Build-frame evaluation positions: the build-time reference wrapped
    into the primary box image plus the minimum-image displacement since
    the build. A plain per-evaluation wrap would teleport an atom that
    crossed a periodic face since the build to the far side of the box,
    where the per-cell image shifts no longer see it correctly."""
    b = torch.as_tensor(box, dtype=pos.dtype, device=pos.device).reshape(3)
    safe = torch.where(b > 0, b, torch.ones_like(b))
    zero = torch.zeros_like(b)
    ref_w = torch.where(b > 0, ref - safe * torch.floor(ref / safe), ref)
    d = pos - ref
    d = d - torch.where(b > 0, safe * torch.round(d / safe), zero)
    return ref_w + d


def displacement_trigger(d2, skin):
    """Rebuild predicate (a bool tensor) from squared displacements since
    the build: a pair absent from the structure can enter the cutoff only
    once the two atoms' combined displacement exceeds the skin, so the sum
    of the two largest displacements decides (exact second max from three
    reductions)."""
    if d2.shape[0] < 2:
        return (d2 > (0.5 * skin) ** 2).any()
    m1 = d2.max()
    hit = d2 == m1
    tied = hit.sum() > 1
    m2 = torch.where(tied, m1, torch.where(hit, torch.full_like(d2, -1.0), d2).max())
    return torch.sqrt(m1) + torch.sqrt(torch.clamp(m2, min=0.0)) > skin


def needs_rebuild(cl: CellList, pos, cfg: CellListConfig, box=None):
    """True (a bool tensor) when the structure may no longer cover all
    cutoff pairs."""
    b = _box_tensor(box, cfg, pos)
    d = pos - cl.ref_pos
    d = d - b * torch.round(d / b)
    return displacement_trigger((d * d).sum(1), cfg.skin)


def build_exclusion_table(parameters, natoms,
                          exclusions=("bonds", "angles", "1-4")) -> np.ndarray:
    """Padded per-atom exclusion lists (numpy int32, `natoms` = empty),
    built once per topology. The width is the actual maximum exclusion
    count (0 columns for systems with no exclusions)."""
    table = [[] for _ in range(natoms)]
    for a, b in parameters.get_exclusions(types=exclusions):
        a, b = int(a), int(b)
        if b not in table[a]:
            table[a].append(b)
        if a not in table[b]:
            table[b].append(a)
    width = max((len(t) for t in table), default=0)
    out = np.full((natoms, width), natoms, dtype=np.int32)
    for i, t in enumerate(table):
        out[i, :len(t)] = t
    return out


def cell_nonbonded_energy_forces(ffp, cfg, clcfg: CellListConfig, cl: CellList,
                                 excl_table, pos, box, with_virial=False):
    """Nonbonded energies + forces in cell-pair form, the plain PyTorch
    version (energies carry the 0.5 symmetric factor: every pair is seen
    from both cells). `excl_table` is the (natoms, E) table of
    `build_exclusion_table`. With `with_virial=True` also the per-axis
    pair virial (3,), -dE/ds_a of E(s pos, s box)."""
    from .ops.cell import cell_reference, prepare_cell_data

    return cell_reference(prepare_cell_data(ffp, excl_table), cfg, clcfg, cl,
                          pos, box, with_virial)


class CellKernel:
    """A static cell configuration and exclusion table with
    build / update / evaluate entry points for one topology.

        cl = kern.build(pos, box)
        pot, forces = kern.energy_forces(pos, box, cl)

    On a CUDA tensor `energy_forces` launches the cell kernel
    (`ops.cell`); on a CPU tensor, or with `plain=True` on any device, it
    runs the plain version. A build that overflows a cell is reported in
    `cl.overflow`; `grow` doubles the capacity."""

    capacity_name = "cell list capacity (atoms per cell)"

    def __init__(self, ffp, cfg, parameters, box, skin=2.0,
                 exclusions=("bonds", "angles", "1-4"), capacity=None,
                 pos0=None, plain=False):
        from .ops import cell as _ops_cell

        if cfg.cutoff is None:
            raise ValueError("Cell lists require a cutoff")
        natoms = int(ffp.charges.shape[0])
        self.ffp = ffp
        self.cfg = cfg
        self.plain = plain
        self.clcfg = make_cell_config(box, cfg.cutoff, skin=skin,
                                      capacity=capacity, natoms=natoms)
        if capacity is None and pos0 is not None:
            self.clcfg = self.clcfg.with_capacity(self._occupancy_capacity(pos0))
        self.excl_table = build_exclusion_table(parameters, natoms, exclusions)
        self.data = _ops_cell.prepare_cell_data(ffp, self.excl_table)

    def _occupancy_capacity(self, pos0) -> int:
        """Capacity from the real occupancy of a starting configuration
        (pair work scales with capacity^2); the overflow retry covers
        later density fluctuations."""
        cid = _cell_ids(torch.as_tensor(np.asarray(pos0), dtype=torch.float64),
                        self.clcfg)
        occ = int(torch.bincount(cid).max()) if len(cid) else 1
        return max(4, int(occ * 1.15) + 2)

    def build(self, pos, box=None) -> CellList:
        return build_cell_list(pos, self.clcfg, box)

    def needs_rebuild(self, cl: CellList, pos, box=None):
        return needs_rebuild(cl, pos, self.clcfg, box)

    def refresh(self, cl, pos, box=None) -> CellList:
        """The structure for `pos`: rebuilt at every call, on the device
        (a sort; no host decision)."""
        return self.build(pos, box)

    def covers(self, box) -> bool:
        """True while box/ncells still hosts rc-wide cells."""
        b = np.asarray(box, np.float64).reshape(-1, 3)
        edges = b.min(axis=0) / np.asarray(self.clcfg.ncells)
        return bool(np.all(edges >= self.clcfg.rc * (1.0 - 1e-9)))

    def with_box(self, box, pos0=None):
        """New kernel for a materially different box (same topology)."""
        new = copy.copy(self)
        new.clcfg = make_cell_config(box, self.cfg.cutoff, skin=self.clcfg.skin,
                                     capacity=self.clcfg.capacity,
                                     natoms=int(self.ffp.charges.shape[0]))
        if pos0 is not None:
            new.clcfg = new.clcfg.with_capacity(new._occupancy_capacity(pos0))
        return new

    def spread_order(self, cl: CellList):
        """The atoms in space order for the PME spread: the cell list's
        slots (each atom once; natoms = empty)."""
        return cl.slots

    def energy_forces(self, pos, box, cl: CellList):
        from .ops import cell as _ops_cell

        fn = _ops_cell.cell_reference if self.plain else _ops_cell.cell_energy_forces
        return fn(self.data, self.cfg, self.clcfg, cl, pos, box)

    def energy_forces_virial(self, pos, box, cl: CellList):
        """(pot, forces, per-axis pair virial (3,)): the MTK barostat's
        scaling virial -dE/ds_a of E(s pos, s box) for the pair terms."""
        from .ops import cell as _ops_cell

        fn = _ops_cell.cell_reference if self.plain else _ops_cell.cell_energy_forces
        return fn(self.data, self.cfg, self.clcfg, cl, pos, box, with_virial=True)

    def grow(self) -> "CellKernel":
        new = copy.copy(self)
        new.clcfg = self.clcfg.with_capacity(self.clcfg.capacity * 2)
        return new


# ----------------------------------------------------------------------
# Verlet lists: a padded per-atom neighbour list with a skin
# ----------------------------------------------------------------------
#
# Counterpart of the JAX package's `VerletConfig` ... `VerletKernel`
# (torchmd_tpu/neighbors.py:676-870): every pair within cutoff + skin
# that the nonbonded mask allows, as an (natoms, capacity) table padded
# with natoms, rebuilt when the displacement since the build could have
# brought an unlisted pair inside the cutoff. It works with or without a
# periodic box (the cell grid needs one). The JAX package has no Pallas
# kernel for it, so it is torch ops on every device: one (N, N) distance
# pass per build, a row gather and the shared pair-block math per
# evaluation.


class VerletConfig(NamedTuple):
    box: tuple            # concrete (lx, ly, lz); zeros = open boundary
    cutoff: float
    skin: float
    capacity: int         # max neighbours per atom (padded width)

    @property
    def rc(self):
        return self.cutoff + self.skin

    @property
    def pbc(self):
        return min(self.box) > 0

    def with_capacity(self, capacity: int) -> "VerletConfig":
        return self._replace(capacity=capacity)


class NeighborList(NamedTuple):
    nbr: torch.Tensor       # (natoms, capacity) int64 neighbour ids, natoms = pad
    ref_pos: torch.Tensor   # positions at build time
    overflow: torch.Tensor  # bool scalar: a row held more than `capacity`


def _verlet_box(vcfg: VerletConfig, box, like):
    """The box of a build or check: the call's when given (a zero box is
    no PBC), else the configuration's; None without PBC."""
    if box is None:
        if not vcfg.pbc:
            return None
        box = vcfg.box
    b = torch.as_tensor(box, dtype=like.dtype, device=like.device).reshape(3)
    return b


def _verlet_d2(pos, vcfg: VerletConfig, box=None):
    """Dense squared-distance matrix (minimum image with a box)."""
    from .potentials import wrap_displacement

    dv = wrap_displacement(pos[:, None, :] - pos[None, :, :], _verlet_box(vcfg, box, pos))
    return (dv * dv).sum(-1)


def build_verlet_list(pos, nb_mask, vcfg: VerletConfig, box=None) -> NeighborList:
    """Each row's in-range neighbours in ascending index order (the JAX
    package's stable argsort order), padded with natoms: a row's rank of
    each valid column from a running count, no sort and no host sync."""
    n = pos.shape[0]
    mask = (_verlet_d2(pos, vcfg, box) <= vcfg.rc * vcfg.rc) & nb_mask
    rank = torch.cumsum(mask, dim=1) - 1
    overflow = (rank[:, -1] + 1 > vcfg.capacity).any() if n else torch.zeros(
        (), dtype=torch.bool, device=pos.device)
    keep = mask & (rank < vcfg.capacity)
    nbr = torch.full((n, vcfg.capacity + 1), n, dtype=torch.int64, device=pos.device)
    # dropped and masked entries land in the spare last column
    slot = torch.where(keep, rank, torch.full_like(rank, vcfg.capacity))
    cols = torch.arange(n, device=pos.device).expand(n, n)
    nbr.scatter_(1, slot, torch.where(keep, cols, torch.full_like(cols, n)))
    return NeighborList(nbr[:, :vcfg.capacity], pos, overflow)


def verlet_needs_rebuild(nl: NeighborList, pos, vcfg: VerletConfig, box=None):
    """True (a bool tensor) when the list may no longer cover all cutoff
    pairs (`displacement_trigger` on the displacements since the build)."""
    from .potentials import wrap_displacement

    d = wrap_displacement(pos - nl.ref_pos, _verlet_box(vcfg, box, pos))
    return displacement_trigger((d * d).sum(1), vcfg.skin)


def verlet_nonbonded_energy_forces(ffp, cfg, vcfg: VerletConfig, nl: NeighborList,
                                   pos, box, with_virial=False):
    """Nonbonded energies and forces from the full padded list: one row
    gather, then the pair-block math of the dense path
    (`potentials.nonbonded_block_energy_forces`; LJ with NBFIX tables,
    switching, RFA, Ewald real space). Forces are complete row sums,
    energies carry the 0.5 symmetric factor; with `with_virial=True` also
    the per-axis pair virial."""
    from .potentials import LJ_FAMILY, nonbonded_block_energy_forces, wrap_displacement
    from .units import ELEC_FACTOR

    n, dtype = pos.shape[0], pos.dtype
    nbr = nl.nbr
    mask = nbr < n
    zero = torch.zeros(1, dtype=dtype, device=pos.device)
    pos_pad = torch.cat([pos, torch.zeros((1, 3), dtype=dtype, device=pos.device)])
    dv = wrap_displacement(pos[:, None, :] - pos_pad[nbr], box)
    qq = None
    if "electrostatics" in cfg.terms:
        q = ffp.charges.to(dtype)
        qq = ELEC_FACTOR * q[:, None] * torch.cat([q, zero])[nbr]
    A_ij = B_ij = None
    if any(t in cfg.terms for t in LJ_FAMILY):
        ti = ffp.mapped_atom_types
        if ffp.lj_ab is not None:
            tj = torch.cat([ti, ti.new_zeros(1)])[nbr]
            A_ij = ffp.lj_ab[0].to(dtype)[ti[:, None], tj]
            B_ij = ffp.lj_ab[1].to(dtype)[ti[:, None], tj]
        else:
            s_at = ffp.lj_params[:, 0].to(dtype)[ti]
            e_at = ffp.lj_params[:, 1].to(dtype)[ti]
            sig = 0.5 * (s_at[:, None] + torch.cat([s_at, zero])[nbr])
            eps = torch.sqrt(torch.abs(e_at[:, None] * torch.cat([e_at, zero])[nbr]))
            s6 = sig**6
            B_ij = 4.0 * eps * s6
            A_ij = B_ij * s6
    return nonbonded_block_energy_forces(cfg, dv, mask, qq, A_ij, B_ij,
                                         with_virial=with_virial)


class VerletKernel:
    """A Verlet-list configuration with build / refresh / evaluate entry
    points for one topology, duck-typed on `CellKernel` so the
    integrator's neighbour-kernel paths and overflow retry take it:

        nl = kern.build(pos, box)
        nl = kern.refresh(nl, pos, box)    # rebuilt only on displacement
        pot, forces = kern.energy_forces(pos, box, nl)

    The capacity (neighbours per atom) is sized from `pos0` when given;
    a build that finds a fuller row sets `nl.overflow`, and `grow`
    doubles the capacity. `rebuilds` counts the builds `refresh` made."""

    capacity_name = "Verlet list capacity (neighbours per atom)"

    def __init__(self, ffp, cfg, box=None, skin=2.0, capacity=None, pos0=None):
        if cfg.cutoff is None:
            raise ValueError("Verlet lists require a cutoff")
        if ffp.nb_mask is None:
            raise ValueError("Verlet lists need the dense nonbonded mask")
        self.ffp = ffp
        self.cfg = cfg
        natoms = int(ffp.charges.shape[0])
        boxt = ((0.0, 0.0, 0.0) if box is None
                else tuple(float(b) for b in np.asarray(box).reshape(-1)[:3]))
        self.vcfg = VerletConfig(boxt, float(cfg.cutoff), float(skin), int(capacity or 0))
        self.rebuilds = 0
        if capacity is None:
            if pos0 is not None:
                p0 = torch.as_tensor(np.asarray(pos0), dtype=torch.float64,
                                     device=ffp.nb_mask.device)
                # size from the real occupancy; overflow growth covers
                # later density fluctuations
                occ = int(((_verlet_d2(p0, self.vcfg) <= self.vcfg.rc**2)
                           & ffp.nb_mask).sum(1).max())
            else:
                occ = 128
            self.vcfg = self.vcfg.with_capacity(max(8, min(natoms, int(occ * 1.2) + 8)))

    @property
    def capacity(self) -> int:
        return self.vcfg.capacity

    def build(self, pos, box=None) -> NeighborList:
        return build_verlet_list(pos, self.ffp.nb_mask, self.vcfg, box)

    def needs_rebuild(self, nl: NeighborList, pos, box=None):
        return verlet_needs_rebuild(nl, pos, self.vcfg, box)

    def refresh(self, nl, pos, box=None) -> NeighborList:
        """The list for `pos`: `nl` while it still covers the cutoff,
        else a new build (one host read of the rebuild flag; the build's
        overflow stays sticky)."""
        if nl is None:
            self.rebuilds += 1
            return self.build(pos, box)
        if not bool(self.needs_rebuild(nl, pos, box)):
            return nl
        self.rebuilds += 1
        new = self.build(pos, box)
        return new._replace(overflow=new.overflow | nl.overflow)

    def spread_order(self, nl):
        """No space order for the PME spread: the atoms' own order."""
        return None

    def energy_forces(self, pos, box, nl: NeighborList):
        return verlet_nonbonded_energy_forces(self.ffp, self.cfg, self.vcfg, nl, pos, box)

    def energy_forces_virial(self, pos, box, nl: NeighborList):
        return verlet_nonbonded_energy_forces(self.ffp, self.cfg, self.vcfg, nl, pos, box,
                                              with_virial=True)

    def grow(self) -> "VerletKernel":
        new = copy.copy(self)
        natoms = int(self.ffp.charges.shape[0])
        new.vcfg = self.vcfg.with_capacity(min(natoms, self.vcfg.capacity * 2))
        return new
