"""External potential (neural-network potential) integration.

The protocol of the reference (torchmd/forces.py:321-326, run.py:186-209)
and of the JAX package (`torchmd_tpu.external`), on torch tensors. Any
object exposing

    calculate(pos[nreplicas, natoms, 3], box) -> (energy[nreplicas],
                                                  forces[nreplicas, natoms, 3])

can be passed as `Forces(external=...)`, as the reference's torch NNPs
are. Objects that expose

    energy_fn(pos[natoms, 3], box[3]) -> scalar energy

as a torch callable (often an `nn.Module`) are evaluated per replica on
the device of the positions, with forces -dE/dpos by `torch.autograd`,
or by their `energy_forces_fn(pos, box) -> (energy, forces)` where they
have one. `Forces` evaluates the external after the internal terms and
adds its forces into the same buffer; an all-zero box reaches the
external as zeros (no PBC). `combine_externals` sums several sources
(restraints and a user's external) into one.
"""

from __future__ import annotations

import numpy as np
import torch


class TorchExternal:
    """Adapter for a torch potential `energy_fn(pos, box) -> scalar`.

    Satisfies both protocol levels: `energy_fn` for the per-replica fold
    into `Forces` and `calculate` for the batched host API. An optional
    analytic `energy_forces_fn(pos, box) -> (energy, forces)` replaces
    the autograd force path."""

    def __init__(self, energy_fn, energy_forces_fn=None):
        self._efn = energy_fn
        if energy_forces_fn is not None:
            # bound attribute, only present when an analytic path exists
            # (external_ef() dispatches on attribute presence)
            self.energy_forces_fn = energy_forces_fn

    def energy_fn(self, pos, box):
        return self._efn(pos, box)

    def calculate(self, pos, box):
        """(energy (R,), forces (R, N, 3)) tensors on the positions'
        device; `pos` a tensor or an array, `box` (R, 3), (R, 3, 3) or
        None."""
        pos = pos if isinstance(pos, torch.Tensor) else torch.as_tensor(np.asarray(pos))
        boxes = batch_box(box, pos)
        ef = external_ef(self)
        out = [ef(p, b) for p, b in zip(pos, boxes)]
        return (torch.stack([e.detach() for e, _ in out]),
                torch.stack([f.detach() for _, f in out]))


def batch_box(box, pos):
    """(R, 3) box diagonals on `pos`'s device and dtype; zeros for None."""
    nrep = pos.shape[0]
    if box is None:
        return torch.zeros((nrep, 3), dtype=pos.dtype, device=pos.device)
    box = torch.as_tensor(box if isinstance(box, torch.Tensor) else np.asarray(box),
                          dtype=pos.dtype, device=pos.device)
    if box.ndim == 3:
        box = torch.diagonal(box, dim1=1, dim2=2)
    return box.reshape(-1, 3).expand(nrep, 3)


def external_ef(external):
    """(pos, box) -> (energy, forces) for an external with a torch
    energy: the object's `energy_forces_fn` when present, else -autograd
    of `energy_fn`. None for externals with only `calculate`."""
    if external is None:
        return None
    ef = getattr(external, "energy_forces_fn", None)
    if ef is not None:
        return ef
    fn = getattr(external, "energy_fn", None)
    if fn is None:
        return None

    def _ef(pos, box):
        with torch.enable_grad():
            p = pos.detach().requires_grad_(True)
            e = fn(p, box).reshape(())
            (g,) = torch.autograd.grad(e, p)
        return e.detach(), -g

    return _ef


def combine_externals(sources):
    """One `TorchExternal` for several sources (restraints, a user's
    external): energies and forces summed, each source's forces by its
    own `energy_forces_fn` or autograd (the JAX CLI's `_combined_ef`,
    torchmd_tpu/run.py:309-330). Every source needs `energy_fn`: a
    host-side external with only `calculate` cannot join."""
    sources = list(sources)
    for src in sources:
        if getattr(src, "energy_fn", None) is None:
            raise NotImplementedError(
                "topology restraints cannot compose with a host-side "
                "external potential (no energy_fn)")
    efs = [external_ef(src) for src in sources]

    def energy_fn(pos, box):
        return sum(src.energy_fn(pos, box) for src in sources)

    def energy_forces_fn(pos, box):
        parts = [ef(pos, box) for ef in efs]
        return sum(e for e, _ in parts), sum(f for _, f in parts)

    return TorchExternal(energy_fn, energy_forces_fn=energy_forces_fn)


class External:
    """Reference-compatible CLI entry point: constructed from an external
    config as `External(file, embeddings, device, **kwargs)`
    (run.py:186-209). `file` is a Python file or a module path defining
    `make_potential(embeddings, **kwargs) -> energy_fn`, a torch callable
    of one conformation; an `nn.Module` is moved to `device`."""

    def __init__(self, file, embeddings, device=None, **kwargs):
        import importlib
        import importlib.util

        if str(file).endswith(".py"):
            spec = importlib.util.spec_from_file_location("_ext_potential", file)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        else:
            mod = importlib.import_module(str(file))
        fn = mod.make_potential(np.asarray(embeddings), **kwargs)
        if isinstance(fn, torch.nn.Module) and device is not None:
            fn = fn.to(device)
        self._inner = TorchExternal(fn)

    def energy_fn(self, pos, box):
        return self._inner.energy_fn(pos, box)

    def calculate(self, pos, box):
        return self._inner.calculate(pos, box)
