"""Differentiable force-field training (force and energy matching), the
port of `torchmd_tpu.train`.

Force-field parameters are tensors, so a potential can be trained against
reference forces and energies (coarse-grained models, say): the loss
differentiates through the force computation, d(loss)/d(params) of F =
-dE/dpos, a double backward through the torch-op `compute_potentials`.
The conformations of a batch are one leading dimension, evaluated with
`torch.func.vmap`; sharding the batch over devices (the JAX package's
`mesh=` with its `dp_axis`/`sp_axis` names) is ROADMAP item 21: `mesh=`
raises here, and the axis names are not taken until then.
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
                 optimizer=None, energy_weight=0.0, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh=: sharding the batch over devices is not ported yet "
                "(ROADMAP item 21)")
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
        x = pos.detach().requires_grad_(True)
        E = self.batched_energy(params, x, box)
        (g,) = torch.autograd.grad(E.sum(), x, create_graph=True)
        loss = ((-g - f_ref) ** 2).mean()
        if self.energy_weight:
            loss = loss + self.energy_weight * ((E - e_ref) ** 2).mean()
        return loss

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
        opt.step()
        return TrainState(state.params, opt, state.step + 1), loss.detach()

    def ffparams(self, state: TrainState) -> FFParams:
        return self._rebuild({k: v.detach() for k, v in state.params.items()})
