"""Differentiable force-field training (force and energy matching), the
port of `torchmd_tpu.train`.

Force-field parameters are tensors, so a potential can be trained against
reference forces and energies (coarse-grained models, say): the loss
differentiates through the force computation, d(loss)/d(params) of F =
-dE/dpos, a double backward through the torch-op `compute_potentials`.
The conformations of a batch are one leading dimension, evaluated with
`torch.func.vmap`. With `mesh=` (a `parallel.Mesh`, one process per
rank; torchmd_tpu/train.py:78-145) the batch shards over `dp_axis` and
each conformation's pair-matrix rows over `sp_axis`: the energy is
`parallel.sharded_energy_fn`'s, every rank differentiates its share of
the loss (its rows' forces, and its part of the energy term), and the
parameter gradients are summed over all ranks before every rank takes
the same optimizer step, so the loss stays the mean over the whole
batch and the parameters equal the unsharded trainer's. Every rank
calls `step` with the same whole batch.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from .potentials import FFParams, ForceTermConfig, total_energy

__all__ = ["TRAINABLE_FIELDS", "split_trainable", "TrainState", "ForceMatchingTrainer"]

TRAINABLE_FIELDS = ("lj", "charges", "bonds", "angles", "dihedrals", "impropers", "1-4")
_TABLES = (("bonds", "bonds"), ("angles", "angles"), ("dihedrals", "dihedrals"),
           ("impropers", "impropers"), ("1-4", "nb14"))


def split_trainable(ffp: FFParams, trainable: Sequence[str]):
    """Split FFParams into (trainable dict, rebuild fn): the dict holds the
    selected parameter tensors (LJ rows, charges, the bonded tables'
    params), rebuild(dict) the FFParams with them in place."""
    train = {}
    if "lj" in trainable and ffp.lj_params is not None:
        train["lj"] = ffp.lj_params
    if "charges" in trainable:
        train["charges"] = ffp.charges
    for name, field in _TABLES:
        tbl = getattr(ffp, field)
        if name in trainable and tbl is not None:
            train[name] = tbl.params

    def rebuild(train_dict) -> FFParams:
        out = ffp
        if "lj" in train_dict:
            out = out._replace(lj_params=train_dict["lj"])
        if "charges" in train_dict:
            out = out._replace(charges=train_dict["charges"])
        for name, field in _TABLES:
            if name in train_dict:
                tbl = getattr(out, field)
                out = out._replace(**{field: tbl._replace(params=train_dict[name])})
        return out

    return train, rebuild


class TrainState(NamedTuple):
    params: dict          # the trainable tensors (leaves with requires_grad)
    opt_state: object     # the torch optimizer over them
    step: int


class ForceMatchingTrainer:
    """Train FFParams tensors to match reference forces (and optionally
    energies) over batches of conformations.

    optimizer: a factory, params -> torch.optim.Optimizer (default
    Adam(lr=1e-3)), for example functools.partial(torch.optim.Adam,
    lr=2.5e-2). The loss is mean((F - f_ref)^2) plus energy_weight x
    mean((E - e_ref)^2), as in the JAX package."""

    def __init__(self, ffp: FFParams, cfg: ForceTermConfig, trainable=("lj",),
                 optimizer=None, energy_weight=0.0, mesh=None, dp_axis="dp", sp_axis="sp"):
        if mesh is not None:
            from .parallel.mesh import Mesh

            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a torchmd_tpu_torch.parallel.Mesh, got "
                                f"{type(mesh).__name__}")
        self.mesh, self.dp_axis, self.sp_axis = mesh, dp_axis, sp_axis
        self.cfg = cfg
        self.energy_weight = energy_weight
        self.optimizer = optimizer or (lambda ps: torch.optim.Adam(ps, lr=1e-3))
        train, self._rebuild = split_trainable(ffp, trainable)
        self._init_params = train

    def batched_energy(self, params, pos, box):
        """(B,) energies of pos (B, N, 3) with boxes (B, 3) (zeros: no
        box) under the FFParams rebuilt from `params`."""
        ffp = self._rebuild(params)
        return torch.func.vmap(lambda p, b: total_energy(ffp, p, b, self.cfg))(pos, box)

    def loss_fn(self, params, pos, box, f_ref, e_ref):
        """mean((F - f_ref)^2) (+ energy_weight x mean((E - e_ref)^2)); on a
        mesh this rank's share of it (`_share`)."""
        if self.mesh is not None:
            return self._share(params, pos, box, f_ref, e_ref)
        x = pos.detach().requires_grad_(True)
        E = self.batched_energy(params, x, box)
        (g,) = torch.autograd.grad(E.sum(), x, create_graph=True)
        loss = ((-g - f_ref) ** 2).mean()
        if self.energy_weight:
            loss = loss + self.energy_weight * ((E - e_ref) ** 2).mean()
        return loss

    def _share(self, params, pos, box, f_ref, e_ref):
        """This rank's share of the loss; the shares of all ranks sum to
        it. The forces of its rows are the gradient of its energy share,
        whose sp all-gather's adjoint adds the other ranks' parts; the
        energy term's all-reduce adjoint all-reduces its gradient, so
        each sp rank carries 1/sp of that term."""
        from .parallel.spatial import sharded_energy_fn

        mesh, sp_axis = self.mesh, self.sp_axis
        efn = sharded_energy_fn(self._rebuild(params), self.cfg, mesh, self.dp_axis, sp_axis)
        nb, natoms = pos.shape[0], pos.shape[1]
        bsl = efn.batch_slice(nb)
        rows = efn.my_rows(pos.detach()).requires_grad_(True)
        e = efn.local(rows, box[bsl])
        (g,) = torch.autograd.grad(e.sum(), rows, create_graph=True)
        loss = ((-g - efn.my_rows(f_ref)) ** 2).sum() / (nb * natoms * 3)
        if self.energy_weight:
            e_tot = mesh.all_reduce_d(e, sp_axis)
            loss = loss + self.energy_weight * ((e_tot - e_ref[bsl]) ** 2).sum() / (
                nb * mesh.shape[sp_axis])
        return loss

    def _world_sum(self, t):
        for axis in self.mesh.axis_names:
            t = self.mesh.all_reduce(t, axis)
        return t

    def init(self) -> TrainState:
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in self._init_params.items()}
        return TrainState(params, self.optimizer(list(params.values())), 0)

    def step(self, state: TrainState, pos, box, f_ref, e_ref=None):
        """One optimizer step on (pos (B, N, 3), box (B, 3), f_ref (B, N,
        3), e_ref (B,)): returns (state, loss). The optimizer updates the
        state's tensors in place."""
        if e_ref is None:
            e_ref = torch.zeros(pos.shape[0], dtype=pos.dtype, device=pos.device)
        opt = state.opt_state
        opt.zero_grad()
        loss = self.loss_fn(state.params, pos, box, f_ref, e_ref)
        loss.backward()
        if self.mesh is not None:
            # every rank's share of the gradient and of the loss, summed
            for p in state.params.values():
                if p.grad is not None:
                    p.grad = self._world_sum(p.grad)
            loss = self._world_sum(loss.detach())
        opt.step()
        return TrainState(state.params, opt, state.step + 1), loss.detach()

    def ffparams(self, state: TrainState) -> FFParams:
        return self._rebuild({k: v.detach() for k, v in state.params.items()})
