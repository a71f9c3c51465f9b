"""A device mesh over the ranks of a `torch.distributed` process group.

Counterpart of `torchmd_tpu.parallel.mesh`. The JAX package is
single-controller: one process drives every chip of a `jax.sharding.Mesh`
under `shard_map`. The port is multi-controller: one process per rank,
each holding its own piece and calling the collectives together. A
`Mesh` names the axes of the world (`("dp", "sp")` by default: replicas
or batch over dp, one system's atom rows over sp), says where this rank
sits on each, holds a process group for this rank's line along each axis,
and carries the collectives the sharded paths use:

  - `all_gather(x, axis)`: row blocks along dim 0, tiled in rank order;
  - `all_reduce(x, axis)`: sum;
  - `reduce_scatter(x, axis)`: sum, then this rank's block of dim 0;
  - `any(flag, axis)`: OR of a bool flag;
  - `ppermute(x, axis, shift)`: this rank's x to its neighbour `shift`
    places on along the axis (periodic), and the x of the rank `shift`
    places back in return (`jax.lax.ppermute` with the permutation
    [(i, (i + shift) % n)], the halo's `fwd` and `bwd`). Its transport
    is fixed when the mesh is built: "p2p" (`batch_isend_irecv`, where
    the backend takes point-to-point on the mesh's tensors: NCCL, and
    gloo on host tensors) or "all_gather" (gloo on CUDA tensors, which
    its point-to-point does not take: every rank of the line gathers the
    blocks and keeps its neighbour's). It is counted in `calls` as
    "ppermute_<transport>" and the bytes this rank received in `bytes`;
    over an axis of one rank it is a local copy (NCCL refuses a send to
    self);
  - `all_gather_d` and `all_reduce_d`: differentiable forms, for the
    trainer, with the adjoints of `torch.distributed.nn.functional`: the
    objective is the sum of every rank's own loss, so all_gather's
    adjoint reduce-scatters the gradient and all_reduce's all-reduces
    it. They are autograd Functions over the collectives above, twice
    differentiable: `torch.distributed.nn`'s own
    all_gather takes its gloo backward through a scatter that names
    global ranks as group ranks, which fails on a subgroup.

The backend is chosen by the caller: NCCL where every rank has a card of
its own, gloo on the CPU or where several ranks share one card. NCCL
refuses two ranks on one card ("Duplicate GPU detected"), so a machine
with one card runs one NCCL rank or several gloo ranks. The
`torch.distributed` documentation's backend table gives gloo only
all_reduce and broadcast on CUDA tensors, but torch 2.11 with CUDA 12.8
on an H100 runs all_gather_into_tensor and
reduce_scatter_tensor on them too, so the collectives take the mesh
device's tensors on either backend and nothing goes through host
memory; a torch whose gloo lacks one raises at the call. `calls` counts
the collectives a mesh ran, by name (a collective over an axis of one
rank is no call).
"""

from __future__ import annotations

import logging
import math
import warnings
from collections import Counter
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "mesh_shape", "replica_sharding", "shard_replicas"]

TRANSPORTS = ("p2p", "all_gather")
_log = logging.getLogger(__name__)


def default_transport(backend, device) -> str:
    """The neighbour shift's transport for a backend and the mesh's
    device: point-to-point where the backend takes it on such tensors
    (NCCL; gloo on the host), else the all_gather form (gloo on CUDA
    tensors: the `torch.distributed` backend table gives gloo no send or
    recv on them)."""
    if str(backend) == "gloo" and torch.device(device).type == "cuda":
        return "all_gather"
    return "p2p"


def mesh_shape(n: int, axes=("dp", "sp"), shape=None) -> tuple:
    """The JAX package's split of `n` devices (torchmd_tpu/parallel/
    mesh.py:24-34): one axis takes all; with two, sp is the largest
    divisor of n not above sqrt(n) and dp = n / sp."""
    if shape is not None:
        shape = tuple(int(s) for s in shape)
        if len(shape) != len(axes) or math.prod(shape) != n:
            raise ValueError(f"mesh shape {shape} does not split {n} ranks over {axes}")
        return shape
    if len(axes) == 1:
        return (n,)
    sp = next(c for c in range(math.isqrt(n), 0, -1) if n % c == 0)
    return (n // sp, sp)


class Mesh:
    """This rank's view of a mesh of `size` ranks; see the module
    docstring. `shape` maps each axis name to its size (as a JAX mesh's
    `shape` does), `coords` to this rank's index along it; the rank's
    global index is row-major over the axes (the JAX package reshapes
    its device list the same way)."""

    def __init__(self, axes, shape, device, backend, rank, groups, members=None,
                 transport=None):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(self.axis_names, shape))
        self.size = math.prod(shape)
        self.rank = rank
        self.coords = dict(zip(self.axis_names, _unravel(rank, shape)))
        self.device = torch.device(device)
        self.backend = backend
        self._groups = groups
        # the global ranks of this rank's line along each axis, in order
        self._members = members or {}
        self.transport = transport or default_transport(backend, self.device)
        if self.transport not in TRANSPORTS:
            raise ValueError(f"transport {self.transport!r}: one of {TRANSPORTS}")
        self.calls: Counter = Counter()
        self.bytes: Counter = Counter()

    def __repr__(self):
        return (f"Mesh({self.shape}, rank={self.rank}, coords={self.coords}, "
                f"device={self.device}, backend={self.backend}, "
                f"transport={self.transport})")

    def index(self, axis) -> int:
        return self.coords[axis]

    def group(self, axis):
        """The process group of this rank's line along `axis`."""
        return self._groups[axis]

    # ------------------------------------------------------------------
    def all_gather(self, x, axis):
        """Blocks of dim 0 from every rank of the axis, concatenated in
        rank order (`jax.lax.all_gather(..., tiled=True)`)."""
        n = self.shape[axis]
        if n == 1:
            return x
        self.calls["all_gather"] += 1
        x = x.contiguous()
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=self.group(axis))
        return out

    def all_reduce(self, x, axis):
        """The sum over the ranks of the axis (`jax.lax.psum`)."""
        if self.shape[axis] == 1:
            return x
        self.calls["all_reduce"] += 1
        out = x.clone()
        dist.all_reduce(out, group=self.group(axis))
        return out

    def reduce_scatter(self, x, axis):
        """The sum over the ranks of the axis, then this rank's block of
        dim 0 (`jax.lax.psum_scatter(..., tiled=True)`); dim 0 divides by
        the axis size."""
        n = self.shape[axis]
        if n == 1:
            return x
        if x.shape[0] % n:
            raise ValueError(f"reduce_scatter: dim 0 of {tuple(x.shape)} does not "
                             f"divide over {axis}={n}")
        self.calls["reduce_scatter"] += 1
        x = x.contiguous()
        out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
        with warnings.catch_warnings():
            # newer torch names it reduce_scatter_single; both run the same
            warnings.simplefilter("ignore", FutureWarning)
            dist.reduce_scatter_tensor(out, x, group=self.group(axis))
        return out

    def any(self, flag, axis):
        """OR of a bool tensor over the ranks of the axis."""
        return self.all_reduce(flag.to(torch.int32), axis) > 0

    def ppermute(self, x, axis, shift):
        """x of the rank `shift` places back along the axis (periodic);
        this rank's x goes to the rank `shift` places on. Every rank of
        the line calls it with the same shape and shift."""
        n = self.shape[axis]
        if n == 1 or shift % n == 0:
            return x.clone()
        x = x.contiguous()
        k = self.coords[axis]
        name = f"ppermute_{self.transport}"
        self.calls[name] += 1
        if self.transport == "all_gather":
            blocks = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
            dist.all_gather_into_tensor(blocks, x, group=self.group(axis))
            self.bytes[name] += (n - 1) * x.numel() * x.element_size()
            return blocks.view((n,) + tuple(x.shape))[(k - shift) % n].clone()
        line = self._members[axis]
        out = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, line[(k + shift) % n], self.group(axis)),
               dist.P2POp(dist.irecv, out, line[(k - shift) % n], self.group(axis))]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        self.bytes[name] += x.numel() * x.element_size()
        return out

    # ------------------------------------------------------------------
    def all_gather_d(self, x, axis):
        """`all_gather`, differentiable: its adjoint is `reduce_scatter`
        of the gradient (and that one's `all_gather`, so a double backward
        goes through)."""
        return _AllGather.apply(x, self, axis)

    def all_reduce_d(self, x, axis):
        """`all_reduce`, differentiable: its adjoint all-reduces the
        gradient."""
        return _AllReduce.apply(x, self, axis)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.all_gather(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _ReduceScatter.apply(g, ctx.mesh, ctx.axis), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.reduce_scatter(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _AllGather.apply(g, ctx.mesh, ctx.axis), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _AllReduce.apply(g, ctx.mesh, ctx.axis), None, None


def _unravel(rank, shape):
    out = []
    for s in reversed(shape):
        out.append(rank % s)
        rank //= s
    return tuple(reversed(out))


def make_mesh(n_devices: Optional[int] = None, axes=("dp", "sp"), shape=None,
              device=None, transport=None) -> Mesh:
    """This rank's `Mesh` over the initialised default process group
    (`torch.distributed.init_process_group`, or `parallel.launch`).
    `n_devices` must be the world size when given; the axes split as
    `mesh_shape` says. Every rank calls it, in the same order, since it
    makes a process group for every line of every axis. `device`
    defaults to the card `cuda:{rank % cards}` on either backend, as the
    port's entry points default to the card; without a card it must be
    given (`"cpu"` for a gloo group on the host). `transport` is the
    neighbour shift's ("p2p" or "all_gather"; default
    `default_transport(backend, device)`), logged at INFO."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "torch.distributed.init_process_group (or use "
                           "torchmd_tpu_torch.parallel.launch) first")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"make_mesh: n_devices={n} but the process group has "
                         f"{world} ranks (one rank per mesh position)")
    shape = mesh_shape(n, axes, shape)
    backend = dist.get_backend()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device; the mesh runs on the card unless asked "
                "otherwise: pass device='cpu' for a gloo group on the host")
        device = f"cuda:{rank % torch.cuda.device_count()}"
    groups, lines = {}, {}
    for a, axis in enumerate(axes):
        # the lines along `axis`: ranks that differ only in that coordinate
        for r in range(n):
            coord = list(_unravel(r, shape))
            if coord[a] != 0:
                continue
            members = []
            for k in range(shape[a]):
                coord[a] = k
                members.append(_ravel(coord, shape))
            group = dist.new_group(members)
            if rank in members:
                groups[axis], lines[axis] = group, members
    mesh = Mesh(axes, shape, device, backend, rank, groups, lines, transport)
    _log.info("mesh %s: backend %s, neighbour shifts by %s", mesh.shape, backend,
              mesh.transport)
    return mesh


def _ravel(coord, shape):
    r = 0
    for c, s in zip(coord, shape):
        r = r * s + c
    return r


def replica_sharding(mesh: Mesh, axis: str = "dp", nreplicas: Optional[int] = None):
    """The replicas this rank owns along `axis`, as a slice of the
    replica axis (the port's counterpart of the JAX NamedSharding
    P(axis)): `nreplicas` split in equal contiguous blocks in rank
    order. Without `nreplicas`, a function of it."""
    def rows(n):
        k = mesh.shape[axis]
        if n % k:
            raise ValueError(f"nreplicas={n} must divide over mesh axis {axis}={k}")
        per = n // k
        return slice(mesh.index(axis) * per, (mesh.index(axis) + 1) * per)

    return rows if nreplicas is None else rows(int(nreplicas))


def shard_replicas(mesh: Mesh, state_arrays, axis: str = "dp"):
    """This rank's block of every (nreplicas, ...) array of a dict, list
    or tuple, moved to the mesh's device."""
    def one(x):
        x = torch.as_tensor(x)
        return x[replica_sharding(mesh, axis, x.shape[0])].to(mesh.device)

    if isinstance(state_arrays, dict):
        return {k: one(v) for k, v in state_arrays.items()}
    if hasattr(state_arrays, "_fields"):
        return type(state_arrays)(*map(one, state_arrays))
    if isinstance(state_arrays, (list, tuple)):
        return type(state_arrays)(map(one, state_arrays))
    return one(state_arrays)
