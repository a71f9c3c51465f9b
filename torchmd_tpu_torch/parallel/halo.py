"""Halo-exchange MD: atoms owned by slabs or pencils of space, with
surface-proportional communication.

Counterpart of `torchmd_tpu.parallel.halo`. The row-block spatial path
(`Integrator(shard="spatial")`) all-gathers every position each step.
This module owns atoms by place instead:

  - the box is cut along x into one slab per rank of the mesh axis (a
    slab at least cutoff + skin wide, so a rank's partners sit in the
    adjacent slabs), or along x and y into pencils (`axis` a pair of
    mesh axis names);
  - each rank holds a fixed-capacity table of the atoms it owns (global
    id, position, velocity, force, reference position; the packed row
    layout below) on the mesh's device;
  - each step it sends its boundary bands (atoms within the ghost band
    of a face) to its two neighbours (`Mesh.ppermute`), x bands first and
    then, on pencils, y bands cut from owned + x ghosts, which carry the
    four diagonal corners along;
  - the pair stage is symmetric (owned rows against owned + ghost rows,
    energies at 0.5: `ops.halo`, the halo form of the cell kernel's tile
    walk), so owned rows get complete forces with no return leg; bonded
    terms run through the bonded kernel on a global-id scatter of the
    visible atoms (`halo_bonded`); classic Ewald sums partial structure
    factors over the mesh, and each rank takes its atoms' reciprocal
    forces from the gradient of |S_local + S_rest|^2 with the rest held
    fixed (differentiating through the sum itself would count the
    gradient once per rank);
  - when an atom has moved more than skin / 2 since the last rebuild
    (one host read of a mesh-wide OR a step), atoms that crossed a face
    migrate to the neighbour (x, then y on pencils), with their
    SETTLE/SHAKE and virtual-site groups whole: a group is owned by the
    rank of its representative atom (`group_reps`), and the ghost band
    widens by twice the largest member-to-representative distance.

Capacities are fixed per call (`HaloSpec`, the JAX package's sizes). An
overflow sets a flag per capacity (owned `Acap`, ghost `Gcap` and
`Gcap2`, migration `Mcap`); `step` then grows all four by half and redoes
the chunk from its start, the Langevin generator rewound, and
`overflow_log` names the capacities that overflowed. (The JAX package ORs
the flags into one and its retry leaves Gcap2 as it was.)

Langevin noise is drawn for the whole system from one `torch.Generator`
on every rank and indexed by global id, so a Langevin run does not depend
on the layout. The step's order is the JAX package's (halo.py:925-985):
half-kick and drift, SHAKE/SETTLE, virtual sites snapped, migration,
ghost exchange, pairs, bonded, Ewald, site forces spread, Langevin and
the second half-kick, RATTLE.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ewald import choose_parameters, erf_over_r_sum
from ..ops import halo as _ops_halo
from ..ops.cell import prepare_cell_data
from ..units import BOLTZMANN, ELEC_FACTOR, TIMEFACTOR
from .halo_bonded import (bonded_forces, build_halo_bonded_plan, default_positions,
                          max_bonded_extent, weighted_bonded_energy)

__all__ = ["HaloSpec", "make_halo_spec", "group_reps", "group_extent", "distribute",
           "HaloMD", "CAPACITIES"]

CAPACITIES = ("Acap", "Gcap", "Gcap2", "Mcap")
MAX_ATTEMPTS = 8     # runs of a chunk, the capacities growing by half after each overflow


def _round_up(n, m):
    return -(-int(n) // m) * m


class HaloSpec(NamedTuple):
    R: int              # ranks along x
    box: tuple          # (lx, ly, lz)
    cutoff: float
    skin: float
    Acap: int           # owned-atom capacity per rank
    Gcap: int           # ghost-band capacity per direction (x phase)
    Mcap: int           # migration capacity per direction per rebuild
    nexcl: int
    # largest member-to-representative distance of any rigid/vsite group:
    # a member can sit up to eps outside its owner's region, so the ghost
    # band widens by 2 eps
    eps: float = 0.0
    Ry: int = 1         # ranks along y (pencils); 1: slabs
    Gcap2: int = 0      # y-phase ghost capacity per direction

    @property
    def slab_w(self):
        return self.box[0] / self.R

    @property
    def pencil_w(self):
        return self.box[1] / self.Ry

    @property
    def band_w(self):
        return self.cutoff + self.skin + 2.0 * self.eps

    def comm_bytes_per_step(self):
        """Per-rank per-step halo traffic by the JAX package's count (send
        and receive, both directions, 7 + nexcl f32 columns a ghost row,
        the y phase on pencils). The port's ghost rows are 4 columns
        (id, x, y, z; `Mesh.bytes` counts what moved)."""
        rows = 7 + self.nexcl
        b = 2 * 2 * rows * self.Gcap * 4
        if self.Ry > 1:
            b += 2 * 2 * rows * self.Gcap2 * 4
        return b


def make_halo_spec(box, cutoff, R, natoms, skin=2.0, nexcl=0, slack=1.35, eps=0.0,
                   Ry=1) -> HaloSpec:
    """Capacities for `natoms` over R x Ry ranks (torchmd_tpu/parallel/
    halo.py:120-156); raises where a slab or pencil is narrower than the
    ghost band."""
    box = tuple(float(b) for b in np.asarray(box).reshape(-1)[:3])
    if min(box) <= 0:
        raise ValueError("halo exchange requires a periodic box")
    Ry = int(Ry)
    slab_w = box[0] / R
    band = cutoff + skin + 2.0 * eps
    if slab_w < band:
        raise ValueError(f"slab width {slab_w:.2f} < ghost band {band:.2f} "
                         f"(cutoff+skin+2*group_eps): too many ranks for this box")
    pencil_w = box[1] / Ry
    if Ry > 1 and pencil_w < band:
        raise ValueError(f"pencil height {pencil_w:.2f} < ghost band {band:.2f} "
                         f"(cutoff+skin+2*group_eps): too many y ranks for this box")
    per = natoms / (R * Ry)
    Acap = _round_up(per * slack + 4 * np.sqrt(per) + 8, 8)
    band_frac = min(1.0, band / slab_w)
    Gcap = _round_up(per * band_frac * (slack + 0.3)
                     + 4 * np.sqrt(max(per * band_frac, 1)) + 8, 8)
    Gcap2 = 0
    if Ry > 1:
        # y bands are cut from owned + both x ghost bands
        yfrac = min(1.0, band / pencil_w) * (1.0 + 2.0 * band_frac)
        Gcap2 = _round_up(per * yfrac * (slack + 0.3)
                          + 4 * np.sqrt(max(per * yfrac, 1)) + 8, 8)
    mig_frac = min(1.0, (skin + eps) / slab_w)
    Mcap = _round_up(per * mig_frac * (slack + 0.3)
                     + 4 * np.sqrt(max(per * mig_frac, 1)) + 8, 8)
    return HaloSpec(int(R), box, float(cutoff), float(skin), int(Acap), int(Gcap),
                    int(Mcap), int(nexcl), float(eps), Ry, int(Gcap2))


# Packed row layout of a rank's table (columns): 0 global id (float;
# natoms = padding), 1:4 position, 4:7 velocity, 7:10 force, 10:13
# reference position (the last rebuild's). Ghost rows are the first 4
# columns; charges and LJ rows are read by id from replicated tables.
_ID, _POS, _VEL, _FRC, _REF = 0, slice(1, 4), slice(4, 7), slice(7, 10), slice(10, 13)
NCOLS = 13
GHOST_COLS = 4


def group_reps(natoms, constraints=None, vsites=()) -> np.ndarray:
    """(natoms,) int32 map atom -> representative atom of its rigid or
    virtual-site group (itself when free): the union of every SETTLE
    triplet, SHAKE pair and site with its hosts, whose smallest id is the
    representative. The halo path owns and migrates whole groups, so
    constraint solves and site snap/spread stay on one rank."""
    parent = np.arange(natoms, dtype=np.int64)

    def find(a):
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    def union(a, b):
        ra, rb = find(int(a)), find(int(b))
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)

    def host(t):
        return np.asarray(torch.as_tensor(t).cpu())

    if constraints is not None:
        if constraints.settle is not None:
            ss = constraints.settle
            for o, h1, h2 in zip(host(ss.oidx), host(ss.h1), host(ss.h2)):
                union(o, h1)
                union(o, h2)
        if constraints.shake is not None:
            for a, b in host(constraints.shake.pairs):
                union(a, b)
    for g in vsites or ():
        sites, hosts = host(g.sites), host(g.hosts)
        for s in range(len(sites)):
            for h in range(g.kind[0]):
                union(sites[s], hosts[s, h])
    return np.asarray([find(i) for i in range(natoms)], np.int32)


def group_extent(pos, box, rep_of) -> float:
    """Largest min-image distance of any atom from its group's
    representative."""
    p = np.asarray(torch.as_tensor(pos).detach().cpu(), np.float64).reshape(-1, 3)
    b = np.asarray(box, np.float64).reshape(3)
    d = p - p[rep_of]
    d -= b * np.round(d / b)
    return float(np.sqrt(np.max(np.sum(d * d, axis=1)))) if len(p) else 0.0


def _pack(mask, rows, cap, pad_row):
    """Up to `cap` rows where `mask`, valid first in stable order, padded
    with `pad_row`: ((cap, D), overflow flag)."""
    if rows.shape[0] < cap:
        extra = cap - rows.shape[0]
        rows = torch.cat([rows, pad_row.expand(extra, -1)])
        mask = torch.cat([mask, mask.new_zeros(extra)])
    order = torch.argsort((~mask).to(torch.uint8), stable=True)[:cap]
    out = torch.where(mask[order][:, None], rows[order], pad_row)
    return out, mask.sum() > cap


def distribute(spec: HaloSpec, rows, rep_of=None):
    """Global packed rows (natoms, D) -> (R * Ry, Acap, D) tables, rank
    r = rx * Ry + ry; owners from the group representative's position with
    `rep_of`. Returns (tables (numpy), overflow)."""
    rows = np.asarray(rows)
    x, y = rows[:, 1], rows[:, 2]
    if rep_of is not None:
        x, y = x[np.asarray(rep_of)], y[np.asarray(rep_of)]
    lx, ly = spec.box[0], spec.box[1]
    xw = x - lx * np.floor(x / lx)
    owner = np.clip((xw / lx * spec.R).astype(int), 0, spec.R - 1)
    if spec.Ry > 1:
        yw = y - ly * np.floor(y / ly)
        owner = owner * spec.Ry + np.clip((yw / ly * spec.Ry).astype(int), 0, spec.Ry - 1)
    n, D = rows.shape
    pad = np.zeros(D, rows.dtype)
    pad[_ID] = n
    nrank = spec.R * spec.Ry
    out = np.tile(pad, (nrank, spec.Acap, 1))
    overflow = False
    for r in range(nrank):
        ids = np.where(owner == r)[0]
        if len(ids) > spec.Acap:
            overflow = True
            ids = ids[:spec.Acap]
        out[r, :len(ids)] = rows[ids]
    return out, overflow


class HaloMD:
    """Halo-exchange MD over one mesh axis (slabs) or two (pencils), on
    this rank of `mesh` (every rank of the axes builds one with the same
    arguments and calls its methods together).

        h = HaloMD(ffp, cfg, mesh, box, excl_table, timestep, T, gamma)
        h.init(pos, vel)
        ekin, epot, T = h.step(niter)
        pos, vel = h.gather()          # global numpy arrays, id order

    `ffp` (the port's FFParams) lies on the mesh's device; its dtype is the
    run's. On the card the pair stage is the halo kernel and the bonded
    stage the bonded kernel, both f32 only (another dtype on the card
    raises); on the CPU their plain versions, at either dtype.
    `constraints` is a `constraints.Constraints` and `vsites` the
    virtual-site groups, both on that device. Counters:
    `migrations` (rebuilds in accepted chunks), `overflow_log`,
    `prep_overflows` (host reads that found a cell beyond the pair
    kernel's `ops.halo.PREP_CAP` rows on some rank; the kernel sorted it
    from device memory, so the step is complete and goes on) with
    `prep_overflow_last`, (rows, rank) of the fullest such cell at the
    last of them, `mesh.calls` and `mesh.bytes`."""

    def __init__(self, ffp, cfg, mesh, box, excl_table=None, timestep=1.0, T=None,
                 gamma=None, axis="sp", seed=1, slack=1.35, constraints=None, vsites=None):
        if cfg.cutoff is None:
            raise ValueError("halo exchange requires a cutoff")
        self.ffp, self.cfg, self.mesh = ffp, cfg, mesh
        self.device, self.dtype = ffp.charges.device, ffp.charges.dtype
        if self.device != mesh.device:
            raise ValueError(f"ffp lies on {self.device}, the mesh on {mesh.device}")
        if self.device.type == "cuda" and self.dtype != torch.float32:
            raise ValueError("HaloMD on the card runs the halo and bonded kernels, "
                             f"single precision only: got {self.dtype}")
        self.axes = (axis,) if isinstance(axis, str) else tuple(axis)
        if len(self.axes) not in (1, 2):
            raise ValueError("halo axis must be one mesh axis (slabs) or a pair (pencils)")
        self.R = mesh.shape[self.axes[0]]
        self.Ry = mesh.shape[self.axes[1]] if len(self.axes) > 1 else 1
        self.rx = mesh.index(self.axes[0])
        self.ry = mesh.index(self.axes[1]) if len(self.axes) > 1 else 0
        n = self.natoms = int(ffp.charges.shape[0])
        excl = (np.zeros((n, 0), np.int32) if excl_table is None
                else np.array(excl_table, np.int32))
        self.excl_table = excl
        self.data = prepare_cell_data(ffp, excl)
        self._box_arg = box
        self._slack = slack
        self.constraints = constraints
        self.vsites = tuple(vsites) if vsites else ()
        self._rep_of = None
        if constraints is not None or self.vsites:
            self._rep_of = group_reps(n, constraints, self.vsites)
        self._virt = np.zeros(n, bool)
        for g in self.vsites:
            self._virt[g.sites.cpu().numpy()] = True
        self._ncon = int(constraints.ncon) if constraints is not None else 0
        self._n_real = n - int(self._virt.sum())
        self.spec = make_halo_spec(box, cfg.cutoff, self.R, n, skin=2.0,
                                   nexcl=excl.shape[1], slack=slack, Ry=self.Ry)
        self._spec_sized = self._rep_of is None
        self.bonded = build_halo_bonded_plan(ffp, cfg)
        self.dt = float(timestep) / TIMEFACTOR
        self.T = T
        self.gamma = None if gamma is None else float(gamma) * TIMEFACTOR / 1000.0
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.migrations = 0
        self.overflow_log: list = []
        # the pair kernel's prep flag: the row count of a cell beyond its
        # cap (ops.halo.PREP_CAP), read with the rebuild flag each step and
        # at the chunk's end; placed at this rank's slot of a vector over
        # the halo's ranks, so the sum over them gathers every rank's count
        self._prep_over = torch.zeros(1, dtype=torch.int32, device=self.device)
        self.prep_overflows = 0
        self.prep_overflow_last = None
        self._rank_hot = torch.zeros(self.R * self.Ry, dtype=torch.int32, device=self.device)
        self._rank_hot[self.rx * self.Ry + self.ry] = 1
        self._table = None
        self._setup_tables()

    # ------------------------------------------------------------------
    def _setup_tables(self):
        """Replicated per-id tables (padding row natoms last)."""
        n, dt, dev = self.natoms, self.dtype, self.device
        m = torch.cat([self.ffp.masses.reshape(-1).to(dt), torch.ones(1, dtype=dt, device=dev)])
        self._mass = torch.where(m > 0, m, torch.ones_like(m))[:, None]
        # massless rows are virtual sites: no acceleration, no noise
        self._live = (m > 0).to(dt)[:, None]
        self._vcoeff = None
        if self.T is not None and self.gamma is not None:
            self._vcoeff = torch.where(
                m > 0, torch.sqrt(2.0 * self.gamma * BOLTZMANN * float(self.T) * self.dt
                                  / self._mass[:, 0]), torch.zeros_like(m))[:, None]
        self._q = torch.cat([self.ffp.charges.to(dt), torch.zeros(1, dtype=dt, device=dev)])
        self._excl = torch.cat([torch.as_tensor(self.excl_table, device=dev).long(),
                                torch.full((1, self.excl_table.shape[1]), n,
                                           dtype=torch.long, device=dev)])
        self._default = default_positions(n, dt, dev)
        self._box = torch.tensor(self.spec.box, dtype=dt, device=dev)
        self._rep = (None if self._rep_of is None else torch.cat([
            torch.as_tensor(self._rep_of, device=dev).long(),
            torch.tensor([n], device=dev)]))
        self._virt_t = torch.cat([torch.as_tensor(self._virt, device=dev),
                                  torch.zeros(1, dtype=torch.bool, device=dev)])
        self._ewald = None
        if self.cfg.ewald_alpha is not None and "electrostatics" in self.cfg.terms:
            self._setup_ewald()

    def _setup_ewald(self):
        """k vectors and prefactors of the classic Ewald sum over the
        static box (HaloMD has no barostat) and its position-free
        self and net-charge terms."""
        box = np.asarray(self.spec.box, np.float64)
        alpha = float(self.cfg.ewald_alpha)
        kmax = choose_parameters(box, self.spec.cutoff).kmax
        nvec = [np.arange(-k, k + 1, dtype=np.float64) for k in kmax]
        kk = [2.0 * np.pi / L * nv for L, nv in zip(box, nvec)]
        k2 = kk[0][:, None, None] ** 2 + kk[1][None, :, None] ** 2 + kk[2][None, None, :] ** 2
        pref = np.where(k2 > 0, np.exp(-k2 / (4.0 * alpha ** 2)) / np.where(k2 > 0, k2, 1.0),
                        0.0)
        V = float(np.prod(box))
        dt, dev = self.dtype, self.device
        q = self.ffp.charges.double().cpu().numpy()
        e_self = -ELEC_FACTOR * alpha / np.sqrt(np.pi) * float(np.sum(q * q))
        e_net = -ELEC_FACTOR * np.pi / (2.0 * V * alpha ** 2) * float(np.sum(q)) ** 2
        self._ewald = dict(
            alpha=alpha,
            n=[torch.as_tensor(nv, dtype=dt, device=dev) for nv in nvec],
            pref=torch.as_tensor(ELEC_FACTOR * (2.0 * np.pi / V) * pref.reshape(
                (2 * kmax[0] + 1) * (2 * kmax[1] + 1), 2 * kmax[2] + 1), dtype=dt,
                device=dev),
            selfnet=e_self + e_net)

    # ------------------------------------------------------------------
    def init(self, pos, vel):
        """Distribute the global (natoms, 3) positions and velocities (the
        same on every rank): this rank keeps the atoms it owns."""
        if self._rep_of is not None:
            # the band widens by 2 eps, measured at the real geometry
            # (+25 % for vibration); capacities the retry raised stay
            eps = 1.25 * group_extent(pos, self._box_arg, self._rep_of)
            if not self._spec_sized or eps > self.spec.eps * (1 + 1e-6):
                old = self.spec
                new = make_halo_spec(self._box_arg, self.cfg.cutoff, self.R, self.natoms,
                                     skin=2.0, nexcl=old.nexcl, slack=self._slack,
                                     eps=max(eps, old.eps), Ry=self.Ry)
                self.spec = new._replace(**{c: max(getattr(new, c), getattr(old, c))
                                            for c in CAPACITIES})
                self._spec_sized = True
        self._check_exclusion_reach(pos)
        self._check_bonded_reach(pos)
        dt, dev = self.dtype, self.device
        pos = torch.as_tensor(pos).detach().to(device=dev, dtype=dt)
        vel = torch.as_tensor(vel).detach().to(device=dev, dtype=dt)
        if self.vsites:
            from ..vsites import apply_vsites

            vel = torch.where(self._virt_t[:-1, None], torch.zeros_like(vel), vel)
            pos = apply_vsites(self.vsites, pos, self._box)
        box = self._box
        if self._rep is not None:
            # every group member takes its representative's image shift:
            # groups stay whole in raw coordinates
            pos = pos - box * torch.floor(pos[self._rep[:-1]] / box)
        else:
            pos = pos - box * torch.floor(pos / box)
        n = self.natoms
        ids = torch.arange(n, dtype=dt, device=dev)[:, None]
        rows = torch.cat([ids, pos, vel, torch.zeros_like(pos), pos], 1)
        tables, overflow = distribute(self.spec, rows.cpu().numpy(), self._rep_of)
        if overflow:
            raise RuntimeError("halo Acap overflow at distribution; raise slack")
        self._table = torch.as_tensor(tables[self.rx * self.Ry + self.ry], device=dev)

    def _check_exclusion_reach(self, pos):
        """An excluded pair must stay inside the ghost band: under Ewald
        its partner's position gives the pair's erf correction."""
        tab = self.excl_table
        if tab.shape[1] == 0:
            return
        p = np.asarray(torch.as_tensor(pos).detach().cpu(), np.float64).reshape(-1, 3)
        box = np.asarray(self.spec.box, np.float64)
        ii, jj = np.nonzero(tab < p.shape[0])
        d = p[ii] - p[tab[ii, jj]]
        d -= box * np.round(d / box)
        dmax = float(np.sqrt(np.max(np.sum(d * d, axis=1)))) if len(ii) else 0.0
        if dmax > 0.9 * self.spec.band_w:
            raise ValueError(
                f"exclusion pair separation {dmax:.2f} A reaches "
                f"{dmax / self.spec.band_w:.0%} of the ghost band ({self.spec.band_w:.2f} A): "
                f"its Ewald reciprocal-space cancellation would be lost when the partner "
                f"leaves the band. Increase skin or reduce rank count.")

    def _check_bonded_reach(self, pos):
        """Every bonded term of an owned atom must be visible: the largest
        bonded extent sits well inside the band."""
        if self.bonded is None:
            return
        dmax = max_bonded_extent(self.bonded, pos, self.spec.box)
        if dmax > 0.9 * self.spec.band_w:
            raise ValueError(
                f"bonded term extent {dmax:.2f} A reaches {dmax / self.spec.band_w:.0%} of "
                f"the ghost band ({self.spec.band_w:.2f} A): owned atoms of that term could "
                f"lose sight of their partners. Increase skin or reduce rank count.")

    # ------------------------------------------------------------------
    @property
    def two_d(self):
        return len(self.axes) > 1 and self.Ry > 1

    def _sum(self, x):
        """Sum over the ranks of the halo's axes."""
        for a in self.axes:
            x = self.mesh.all_reduce(x, a)
        return x

    def geometry(self) -> _ops_halo.HaloGeom:
        """This rank's region for the pair stage: x never wraps (ghosts
        come shifted), y wraps on slabs, z always; the unwrapped axes'
        region is the rank's slab or pencil widened by the band and the
        skin (as far as a ghost reaches)."""
        s = self.spec
        lx, ly, _ = s.box
        reach = s.band_w + s.skin
        lo = [self.rx * lx / s.R - reach, self.ry * ly / s.Ry - reach, 0.0]
        hi = [(self.rx + 1) * lx / s.R + reach, (self.ry + 1) * ly / s.Ry + reach, s.box[2]]
        return _ops_halo.HaloGeom(box=s.box, wrap=(False, not self.two_d, True),
                                  lo=tuple(lo), hi=tuple(hi))

    def pair_inputs(self):
        """The pair stage's inputs at the current state: (rows (M, 4), the
        owned rows' count, this rank's `geometry()`), after one ghost
        exchange (a collective)."""
        flags = torch.zeros(5, dtype=torch.bool, device=self.device)
        ghosts = self._ghost_exchange(self._table, flags)
        return (torch.cat([self._table[:, :GHOST_COLS], ghosts]), self._table.shape[0],
                self.geometry())

    def _pad_row(self, cols):
        row = torch.zeros(cols, dtype=self.dtype, device=self.device)
        row[_ID] = self.natoms
        return row

    def _ids(self, atoms):
        ids = atoms[:, _ID].long()
        return ids, ids < self.natoms

    def _marks(self, ids, valid):
        """(natoms + 1,) 1 at the atoms of the valid `ids`, else 0."""
        w = torch.zeros(self.natoms + 1, dtype=self.dtype, device=self.device)
        w.index_put_((ids,), valid.to(self.dtype))
        w[-1] = 0.0
        return w

    def _scatter(self, ids, valid, values, base):
        """`base` (natoms + 1, 3) with the rows of `ids` set to `values`
        (padding rows write row natoms its own value)."""
        out = base.clone()
        out.index_copy_(0, ids, torch.where(valid[:, None], values, base[ids]))
        return out

    # ------------------------------------------------------------------
    # The step's stages
    # ------------------------------------------------------------------
    def _ghost_exchange(self, atoms, flags):
        """Ghost rows (2 Gcap [+ 2 Gcap2], 4): x bands to both x
        neighbours, then on pencils y bands of owned + x ghosts to both y
        neighbours (the forwarded x ghosts cover the corners)."""
        s = self.spec
        lx, ly, _ = s.box
        band = s.band_w
        src = atoms[:, :GHOST_COLS]
        ids, valid = self._ids(atoms)
        pad = self._pad_row(GHOST_COLS)
        x = src[:, 1]
        lo, hi = self.rx * (lx / s.R), (self.rx + 1) * (lx / s.R)
        send_r, of_r = _pack(valid & (x > hi - band), src, s.Gcap, pad)
        send_l, of_l = _pack(valid & (x < lo + band), src, s.Gcap, pad)
        # the rank that crosses the periodic face shifts its band
        if self.rx == s.R - 1:
            send_r[:, 1] -= lx
        if self.rx == 0:
            send_l[:, 1] += lx
        ax = self.axes[0]
        ghosts = torch.cat([self.mesh.ppermute(send_r, ax, 1),
                            self.mesh.ppermute(send_l, ax, -1)])
        flags[1] |= of_r | of_l
        if not self.two_d:
            return ghosts
        src = torch.cat([src, ghosts])
        y = src[:, 2]
        validy = src[:, _ID] < self.natoms
        lo_y, hi_y = self.ry * (ly / s.Ry), (self.ry + 1) * (ly / s.Ry)
        send_u, of_u = _pack(validy & (y > hi_y - band), src, s.Gcap2, pad)
        send_d, of_d = _pack(validy & (y < lo_y + band), src, s.Gcap2, pad)
        if self.ry == s.Ry - 1:
            send_u[:, 2] -= ly
        if self.ry == 0:
            send_d[:, 2] += ly
        ay = self.axes[1]
        flags[2] |= of_u | of_d
        return torch.cat([ghosts, self.mesh.ppermute(send_u, ay, 1),
                          self.mesh.ppermute(send_d, ay, -1)])

    def _rep_xy(self, atoms):
        """Positions wrapped into the box by the group representative's
        image shift, and the representative's wrapped (x, y), which
        decides the owner."""
        ids, valid = self._ids(atoms)
        pos, box = atoms[:, _POS], self._box
        if self._rep is not None:
            pos_g = self._scatter(ids, valid, pos, self._default)
            prep = pos_g[self._rep[ids]]
            shift = -box * torch.floor(prep / box)
            pos_w = pos + torch.where(valid[:, None], shift, torch.zeros_like(shift))
            xy = (prep + shift)[:, :2]
        else:
            pos_w = pos - box * torch.floor(pos / box)
            xy = pos_w[:, :2]
        out = atoms.clone()
        out[:, _POS] = pos_w
        return out, xy

    def _migrate_axis(self, atoms, coord, rank, nrank, axis, L, flags):
        """One migration phase along one mesh axis: rows whose owner is a
        neighbour go there (Mcap a direction), the rest stay; the merged
        table is repacked to Acap."""
        if nrank == 1:
            return atoms
        s = self.spec
        _, valid = self._ids(atoms)
        owner = torch.clamp((coord / L * nrank).long(), 0, nrank - 1)
        d_off = torch.remainder(owner - rank + 1 + nrank, nrank) - 1
        pad = self._pad_row(NCOLS)
        send_r, of_r = _pack(valid & (d_off == 1), atoms, s.Mcap, pad)
        send_l, of_l = _pack(valid & (d_off == -1), atoms, s.Mcap, pad)
        # an owner beyond the neighbours: the skin guarantee was broken
        flags[4] |= (valid & (d_off.abs() > 1)).any()
        keep = valid & (d_off == 0)
        cand = torch.cat([torch.where(keep[:, None], atoms, pad),
                          self.mesh.ppermute(send_r, axis, 1),
                          self.mesh.ppermute(send_l, axis, -1)])
        merged, of_m = _pack(cand[:, _ID] < self.natoms, cand, s.Acap, pad)
        flags[3] |= of_r | of_l
        flags[0] |= of_m
        return merged

    def _migrate(self, atoms, flags):
        """Rebuild: re-wrap by group, move the rows that crossed a face
        (x, then y on pencils: a diagonal move completes across the two),
        reset the reference positions."""
        s = self.spec
        atoms, xy = self._rep_xy(atoms)
        atoms = self._migrate_axis(atoms, xy[:, 0], self.rx, s.R, self.axes[0], s.box[0],
                                   flags)
        if self.two_d:
            _, xy = self._rep_xy(atoms)
            atoms = self._migrate_axis(atoms, xy[:, 1], self.ry, s.Ry, self.axes[1],
                                       s.box[1], flags)
        atoms = atoms.clone()
        atoms[:, _REF] = atoms[:, _POS]
        return atoms

    def _needs_rebuild(self, atoms) -> bool:
        """Has any atom of the mesh moved more than skin / 2 since the last
        rebuild? (One host read, which also records the pair kernel's
        prep flag, `_record_prep`.)"""
        _, valid = self._ids(atoms)
        d = atoms[:, _POS] - atoms[:, _REF]
        d = d - self._box * torch.round(d / self._box)
        moved = (valid & ((d * d).sum(1) > (0.5 * self.spec.skin) ** 2)).any()
        flags = self._sum(torch.cat([moved.to(torch.int32).reshape(1),
                                     self._rank_hot * self._prep_over])).tolist()
        self._record_prep(flags[1:])
        return flags[0] > 0

    def _record_prep(self, counts):
        """Count a read that found a rank's pair-kernel prep beyond its cap
        (`counts`: each rank's flag, by rank) in `prep_overflows`, keep the
        fullest such cell's rows and its rank in `prep_overflow_last`, and
        clear the flag. The kernel sorted that cell from device memory, so
        its forces are complete and the step goes on (the JAX halo's pair
        stage has no cells and runs any density)."""
        rank = int(np.argmax(counts))
        if counts[rank] > 0:
            self._prep_over.zero_()
            self.prep_overflows += 1
            self.prep_overflow_last = (int(counts[rank]), rank)

    def _recip(self, pos, q):
        """(global reciprocal energy, this rank's reciprocal forces): the
        partial structure factors summed over the mesh; forces from the
        gradient of |S_local + S_rest|^2, S_rest held fixed."""
        ew = self._ewald
        box = self.spec.box
        ctype = torch.complex128 if self.dtype == torch.float64 else torch.complex64
        with torch.enable_grad():
            p = pos.detach().requires_grad_(True)

            def phase(a):
                ang = (2.0 * math.pi / box[a]) * torch.outer(p[:, a], ew["n"][a])
                return torch.polar(torch.ones_like(ang), ang).to(ctype)

            wxy = torch.einsum("jx,jy->xyj", phase(0) * q.to(ctype)[:, None], phase(1))
            s_loc = wxy.reshape(-1, p.shape[0]) @ phase(2)
            s_all = torch.view_as_complex(self._sum(torch.view_as_real(s_loc.detach())
                                                    .contiguous()))
            s = s_loc + (s_all - s_loc.detach())
            e = (ew["pref"] * (s.real ** 2 + s.imag ** 2)).sum()
            (g,) = torch.autograd.grad(e, p)
        return e.detach() + ew["selfnet"], -g

    def _excluded_erf(self, pos_g, atoms):
        """The Ewald correction of this rank's excluded pairs: -qq
        erf(alpha r) / r at the minimum image, energy halved (both owners
        count a pair), forces on the owned rows."""
        ids, valid = self._ids(atoms)
        partners = self._excl[ids]                              # (Acap, E)
        ok = valid[:, None] & (partners < self.natoms)
        dv = atoms[:, None, _POS] - pos_g[partners]
        dv = dv - self._box * torch.round(dv / self._box)
        qq = torch.where(ok, ELEC_FACTOR * self._q[ids][:, None] * self._q[partners],
                         torch.zeros_like(dv[..., 0]))
        e, grad = erf_over_r_sum(self._ewald["alpha"], dv.reshape(-1, 3), qq.reshape(-1))
        return 0.5 * e, -grad.reshape(dv.shape).sum(1)

    def _constrain_positions(self, atoms, pos_prev):
        from ..constraints import apply_position_constraints

        ids, valid = self._ids(atoms)
        n = self.natoms
        posn = self._scatter(ids, valid, atoms[:, _POS], self._default)
        posr = self._scatter(ids, valid, pos_prev, self._default)
        posc = apply_position_constraints(self.constraints, posn[:n], posr[:n])
        d = torch.cat([posc - posn[:n], torch.zeros_like(posc[:1])])
        return torch.where(valid[:, None], d[ids], torch.zeros_like(pos_prev))

    def _constrain_velocities(self, atoms):
        from ..constraints import apply_velocity_constraints

        ids, valid = self._ids(atoms)
        n = self.natoms
        pos = self._scatter(ids, valid, atoms[:, _POS], self._default)
        vel = self._scatter(ids, valid, atoms[:, _VEL], torch.zeros_like(self._default))
        velc = apply_velocity_constraints(self.constraints, pos[:n], vel[:n])
        d = torch.cat([velc - vel[:n], torch.zeros_like(velc[:1])])
        return torch.where(valid[:, None], d[ids], torch.zeros_like(atoms[:, _VEL]))

    def _snap_sites(self, atoms):
        from ..vsites import apply_vsites

        ids, valid = self._ids(atoms)
        pos_g = self._scatter(ids, valid, atoms[:, _POS], self._default)
        snapped = torch.cat([apply_vsites(self.vsites, pos_g[:-1], self._box),
                             pos_g[-1:]])
        take = self._virt_t[ids] & valid
        out = atoms.clone()
        out[:, _POS] = torch.where(take[:, None], snapped[ids], atoms[:, _POS])
        return out

    def _spread_sites(self, atoms, frc):
        """Site forces onto their (co-owned) hosts; unowned rows carry
        zero force."""
        from ..vsites import spread_vsite_forces

        ids, valid = self._ids(atoms)
        pos_g = self._scatter(ids, valid, atoms[:, _POS], self._default)
        f_g = self._scatter(ids, valid, frc, torch.zeros_like(self._default))
        f_s = torch.cat([spread_vsite_forces(self.vsites, pos_g[:-1], f_g[:-1], self._box),
                         torch.zeros_like(f_g[:1])])
        return torch.where(valid[:, None], f_s[ids], torch.zeros_like(frc))

    def _forces(self, atoms, ghosts, want_energy):
        """(this rank's potential energy or None, its owned rows' forces,
        the global reciprocal energy): pairs, the Ewald exclusion
        correction, bonded terms, the reciprocal sum, site spread."""
        ids, valid = self._ids(atoms)
        acap = atoms.shape[0]
        rows = torch.cat([atoms[:, :GHOST_COLS], ghosts])
        geom = self.geometry()
        pot, frc = _ops_halo.halo_energy_forces(self.data, self.cfg, rows, acap, geom,
                                                overflow=self._prep_over)
        e_part = sum(pot.values(), frc.new_zeros(())) if want_energy else None
        need_vis = self.bonded is not None or (self._ewald is not None
                                               and self.excl_table.shape[1])
        if need_vis:
            gid = rows[:, _ID].long()
            gvalid = gid < self.natoms
            # ghosts first, then the owned rows (an owned atom's ghost image
            # can come back on two ranks or fewer: any image will do, the
            # terms take the minimum image)
            pos_g = self._scatter(gid[acap:], gvalid[acap:], rows[acap:, 1:4], self._default)
            pos_g = self._scatter(ids, valid, atoms[:, _POS], pos_g)
        if self._ewald is not None and self.excl_table.shape[1]:
            e_ex, f_ex = self._excluded_erf(pos_g, atoms)
            frc = frc + f_ex
            if want_energy:
                e_part = e_part + e_ex
        if self.bonded is not None:
            f_b = bonded_forces(self.bonded, pos_g, self._marks(gid, gvalid), self._box)
            f_b = torch.cat([f_b, torch.zeros_like(f_b[:1])])
            frc = frc + torch.where(valid[:, None], f_b[ids], torch.zeros_like(frc))
            if want_energy:
                e_part = e_part + weighted_bonded_energy(
                    self.bonded, pos_g, self._marks(ids, valid), self._box, "mean")
        e_recip = None
        if self._ewald is not None:
            q = torch.where(valid, self._q[ids], torch.zeros_like(self._q[ids]))
            e_recip, f_r = self._recip(atoms[:, _POS], q)
            frc = frc + f_r
        if self.vsites:
            frc = self._spread_sites(atoms, frc)
        return e_part, torch.where(valid[:, None], frc, torch.zeros_like(frc)), e_recip

    def _run(self, atoms, niter):
        """`niter` steps from this rank's table: (table, its potential
        energy part at the last step, the reciprocal energy, overflow
        flags (Acap, Gcap, Gcap2, Mcap, far), rebuilds)."""
        dt = self.dt
        flags = torch.zeros(5, dtype=torch.bool, device=self.device)
        rebuilds = 0
        e_part = e_recip = None
        for it in range(niter):
            last = it == niter - 1
            ids, valid = self._ids(atoms)
            m, live = self._mass[ids], self._live[ids]
            acc = live * atoms[:, _FRC] / m
            pos_prev = atoms[:, _POS]
            atoms = atoms.clone()
            atoms[:, _POS] = pos_prev + atoms[:, _VEL] * dt + 0.5 * acc * dt * dt
            atoms[:, _VEL] = atoms[:, _VEL] + 0.5 * acc * dt
            if self.constraints is not None:
                dpos = self._constrain_positions(atoms, pos_prev)
                atoms[:, _POS] += dpos
                atoms[:, _VEL] += dpos / dt
            if self.vsites:
                atoms = self._snap_sites(atoms)
            if self._needs_rebuild(atoms):
                atoms = self._migrate(atoms, flags)
                rebuilds += 1
            ghosts = self._ghost_exchange(atoms, flags)
            e_part, frc, e_recip = self._forces(atoms, ghosts, last)
            ids, valid = self._ids(atoms)
            m, live = self._mass[ids], self._live[ids]
            vel = atoms[:, _VEL]
            if self._vcoeff is not None:
                noise = torch.randn((self.natoms, 3), generator=self.generator,
                                    dtype=self.dtype, device=self.device)
                noise = torch.cat([noise, torch.zeros_like(noise[:1])])
                vel = vel - self.gamma * live * vel * dt + noise[ids] * self._vcoeff[ids]
            atoms[:, _FRC] = frc
            atoms[:, _VEL] = vel + 0.5 * dt * live * frc / m
            if self.constraints is not None:
                atoms[:, _VEL] += self._constrain_velocities(atoms)
        return atoms, e_part, e_recip, flags, rebuilds

    # ------------------------------------------------------------------
    def step(self, niter=1):
        """`niter` steps on every rank: (ekin, epot, T) of the whole
        system after the last. An overflow grows every capacity and
        redoes the chunk from its start."""
        if self._table is None:
            raise RuntimeError("call init(pos, vel) first")
        start = self._table
        rng = self.generator.get_state()
        for _ in range(MAX_ATTEMPTS):
            atoms, e_part, e_recip, flags, rebuilds = self._run(start, int(niter))
            ids, valid = self._ids(atoms)
            ke = 0.5 * torch.where(valid[:, None], self._mass[ids] * atoms[:, _VEL] ** 2,
                                   torch.zeros_like(atoms[:, _VEL])).sum()
            tot = self._sum(torch.cat([flags.double(), ke.double().reshape(1),
                                       e_part.double().reshape(1),
                                       (self._rank_hot * self._prep_over).double()]))
            tot = tot.cpu().numpy()
            self._record_prep(tot[7:])
            if tot[4] > 0:
                raise RuntimeError("halo migration: an atom's owner is beyond the "
                                   "neighbouring ranks (it moved more than a slab width "
                                   "between rebuilds)")
            over = [c for c, f in zip(CAPACITIES, tot[:4]) if f > 0]
            if not over:
                break
            self.overflow_log.append(over)
            grown = {c: _round_up(getattr(self.spec, c) * 3 // 2, 8) for c in CAPACITIES}
            if self.spec.Ry == 1:
                grown["Gcap2"] = 0
            old = self.spec.Acap
            self.spec = self.spec._replace(**grown)
            # the chunk's start, padded to the grown table, and the
            # generator rewound: the redo is the run that never overflowed
            start = torch.cat([start, self._pad_row(NCOLS).expand(self.spec.Acap - old, -1)])
            self.generator.set_state(rng)
        else:
            raise RuntimeError(f"halo capacities kept overflowing: {self.overflow_log}")
        self._table = atoms
        self.migrations += rebuilds
        ekin = float(tot[5])
        epot = float(tot[6]) + (0.0 if e_recip is None else float(e_recip))
        ndof = max(3 * self._n_real - self._ncon, 1)
        return ekin, epot, 2.0 * ekin / (BOLTZMANN * ndof)

    # ------------------------------------------------------------------
    def gather(self):
        """Global (natoms, 3) positions and velocities in id order, as
        numpy f64 on every rank (a collective: every rank calls it)."""
        t = self._table
        for a in self.axes:
            t = self.mesh.all_gather(t, a)
        t = t.double().cpu().numpy()
        ids = t[:, _ID].astype(int)
        sel = ids < self.natoms
        pos = np.zeros((self.natoms, 3))
        vel = np.zeros((self.natoms, 3))
        pos[ids[sel]] = t[sel][:, _POS]
        vel[ids[sel]] = t[sel][:, _VEL]
        return pos, vel
