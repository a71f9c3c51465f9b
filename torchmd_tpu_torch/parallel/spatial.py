"""Spatially sharded energy evaluation: the atom rows of the O(N^2) pair
matrix split over a mesh axis, positions all-gathered, partial energies
summed over the axis.

Counterpart of `torchmd_tpu.parallel.spatial`, on one process per rank
(`parallel.mesh`). The pair math is `potentials.rowblock_energy_forces`
(re-exported here under the JAX name), the dense block math on a slice
of rows that the dense path and the kernels' plain versions use, so NBFIX A/B tables, the LJ switch, the
reaction field and Ewald real space behave as on the dense path; the
bonded terms, and the Ewald reciprocal sum when given, are evaluated on
every rank of the row axis and divided by its size.

The result is differentiable with respect to positions and parameters
through the mesh's differentiable collectives (`Mesh.all_gather_d`,
`all_reduce_d`), whose adjoints take the objective as the sum of every
rank's own loss: `ShardedEnergy.local` gives a rank its share of the
energy as a function of its own rows, and the force-matching trainer
differentiates that twice. `energy_forces` gives every rank the energies
and forces of the whole batch.

Row layout: the atoms pad to a multiple of 32 x sp rows (`padded_rows`),
so every rank's block of rows is whole 32-atom tiles of the dense pair
kernel (`ops.nonbonded`'s row range); padding rows carry no charge, LJ
type 0 and a fully masked pair row, and appear in no output.
"""

from __future__ import annotations

import torch

from ..potentials import (
    NONBONDED_TERMS,
    FFParams,
    ForceTermConfig,
    compute_potentials,
    rowblock_energy_forces,
)

__all__ = ["TILE", "padded_rows", "pad_rows", "pad_ffparams_rows",
           "rowblock_energy_forces", "sharded_energy_fn", "ShardedEnergy", "slab"]

TILE = 32  # atoms per tile of the dense pair kernel (ops.nonbonded.TILE)


def padded_rows(natoms: int, nranks: int) -> int:
    """Rows of the padded layout: natoms rounded up to whole tiles on
    each of `nranks` ranks."""
    step = TILE * nranks
    return -(-natoms // step) * step


def pad_rows(a, npad, value=0.0):
    """`a` with dim -2 (atoms) padded to `npad` rows of `value`."""
    pad = npad - a.shape[-2]
    if pad <= 0:
        return a
    fill = a.new_full(a.shape[:-2] + (pad, a.shape[-1]), value)
    return torch.cat([a, fill], dim=-2)


def _pad0(a, npad):
    pad = npad - a.shape[0]
    if pad <= 0:
        return a
    return torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])


def pad_ffparams_rows(ffp: FFParams, npad: int) -> FFParams:
    """Pad the per-atom arrays (and the pair mask) to `npad` rows
    (torchmd_tpu/parallel/spatial.py:52-62): padding atoms carry zero
    charge, LJ type 0 and a fully masked pair row."""
    nb_mask = ffp.nb_mask
    if nb_mask is not None:
        n = nb_mask.shape[0]
        full = torch.zeros((npad, npad), dtype=nb_mask.dtype, device=nb_mask.device)
        full[:n, :n] = nb_mask
        nb_mask = full
    return ffp._replace(charges=_pad0(ffp.charges, npad),
                        mapped_atom_types=_pad0(ffp.mapped_atom_types, npad),
                        nb_mask=nb_mask)


def slab(ncx: int, nranks: int, index: int):
    """(cx0, nloc) of rank `index`'s slab of cell columns along x, the
    JAX package's rule (torchmd_tpu/integrator.py:2337-2338): nloc =
    min(ceil(ncx / nranks), ncx), cx0 = index * nloc; the columns
    [cx0, min(cx0 + nloc, ncx)) are the rank's, none when cx0 >= ncx."""
    nloc = min(-(-ncx // nranks), ncx)
    return index * nloc, nloc


class ShardedEnergy:
    """efn(pos (B, N, 3), box (B, 3)) -> (B,) energies on every rank: the
    batch shards over `dp_axis` (B divides by its size), each
    conformation's pair-matrix rows over `sp_axis`. See the module
    docstring; `sharded_energy_fn` builds it."""

    def __init__(self, ffp: FFParams, cfg: ForceTermConfig, mesh, dp_axis="dp",
                 sp_axis="sp", ewald=None):
        self.cfg, self.mesh, self.ewald = cfg, mesh, ewald
        self.dp_axis, self.sp_axis = dp_axis, sp_axis
        self.natoms = int(ffp.charges.shape[0])
        self.sp = mesh.shape[sp_axis]
        self.npad = padded_rows(self.natoms, self.sp)
        self.rows = self.npad // self.sp
        self.row0 = mesh.index(sp_axis) * self.rows
        self.has_nb = (any(t in cfg.terms for t in NONBONDED_TERMS)
                       and ffp.nb_mask is not None)
        self.ffp_pad = pad_ffparams_rows(ffp, self.npad) if self.has_nb else ffp
        # bonded terms (the 1-4 pairs among them) on every rank of the row
        # axis; without the mask compute_potentials skips the dense block
        self.ffp_bonded = ffp._replace(nb_mask=None)

    def batch_slice(self, nbatch):
        k = self.mesh.shape[self.dp_axis]
        if nbatch % k:
            raise ValueError(f"batch {nbatch} must divide over mesh axis "
                             f"{self.dp_axis}={k}")
        per = nbatch // k
        return slice(self.mesh.index(self.dp_axis) * per,
                     (self.mesh.index(self.dp_axis) + 1) * per)

    def my_rows(self, a):
        """This rank's block of (B, N, ...) arrays: its batch slice and its
        rows of the padded layout."""
        a = pad_rows(a[self.batch_slice(a.shape[0])], self.npad)
        return a[:, self.row0:self.row0 + self.rows]

    def local(self, rows, box):
        """This rank's share of the energy of its batch slice, (B/dp,),
        from its rows (B/dp, rows, 3) (`my_rows`) and boxes (B/dp, 3):
        its row block's pair energies plus 1/sp of the replicated terms.
        Summed over the sp axis it is the energy; differentiable in
        `rows` through the sp all-gather, and in the parameters."""
        n, sp_axis = self.natoms, self.sp_axis
        full = self.mesh.all_gather_d(rows.transpose(0, 1), sp_axis).transpose(0, 1)
        out = []
        for b in range(rows.shape[0]):
            bx = box[b] if box is not None else None
            e = rows.new_zeros(())
            if self.has_nb:
                pot, _ = rowblock_energy_forces(self.ffp_pad, self.cfg, rows[b], full[b],
                                                bx, self.row0)
                e = e + sum(pot.values())
            rep = sum(compute_potentials(self.ffp_bonded, full[b, :n], bx, self.cfg).values(),
                      rows.new_zeros(()))
            if self.ewald is not None:
                rep = rep + self.ewald.energy(full[b, :n], bx)
            out.append(e + rep / self.sp)
        return torch.stack(out)

    def _gather_batch(self, e):
        return self.mesh.all_gather(e, self.dp_axis)

    def __call__(self, pos, box):
        rows = self.my_rows(pos)
        with torch.no_grad():
            e = self.mesh.all_reduce(self.local(rows, box[self.batch_slice(pos.shape[0])]),
                                     self.sp_axis)
        return self._gather_batch(e)

    def energy_forces(self, pos, box):
        """((B,) energies, (B, N, 3) forces) on every rank: each rank's
        rows' forces from the gradient of its share (the sp all-gather's
        adjoint sums the other ranks' parts), gathered."""
        bsl = self.batch_slice(pos.shape[0])
        with torch.enable_grad():
            rows = self.my_rows(pos.detach()).requires_grad_(True)
            e = self.local(rows, box[bsl])
            (g,) = torch.autograd.grad(e.sum(), rows)
        e = self.mesh.all_reduce(e.detach(), self.sp_axis)
        f = self.mesh.all_gather(-g.transpose(0, 1).contiguous(), self.sp_axis)
        f = f.transpose(0, 1)[:, :self.natoms]
        return self._gather_batch(e), self._gather_batch(f.contiguous())


def sharded_energy_fn(ffp: FFParams, cfg: ForceTermConfig, mesh, dp_axis="dp",
                      sp_axis="sp", ewald=None) -> ShardedEnergy:
    """`efn(pos_batch (B, N, 3), box_batch (B, 3)) -> (B,)`, the batch
    over `dp_axis`, each conformation's rows over `sp_axis`
    (torchmd_tpu/parallel/spatial.py:80-135). `ewald`: an optional
    reciprocal term (`ewald.EwaldRecip`) whose energy is added, evaluated
    on every sp rank and divided by sp. Every rank calls it with the same
    batch."""
    return ShardedEnergy(ffp, cfg, mesh, dp_axis, sp_axis, ewald)
