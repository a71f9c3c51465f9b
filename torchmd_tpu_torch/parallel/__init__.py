"""The device mesh of the port: replica and spatial sharding over
`torch.distributed`, one process per rank (`torchmd_tpu.parallel`'s
counterpart). `make_mesh` builds this rank's `Mesh` over an initialised
process group (`launch.Ranks` spawns one), `replica_sharding` gives the
replicas a rank owns, and `sharded_energy_fn` the batch- and row-sharded
energy that `train.ForceMatchingTrainer(mesh=)` differentiates.
`Integrator(mesh=..., shard="replica" | "spatial")` steps on it.
`HaloMD` (with `make_halo_spec`) is halo-exchange MD: atoms owned by
slabs or pencils of space, ghost bands exchanged with the neighbours."""

from .halo import HaloMD, make_halo_spec
from .mesh import Mesh, make_mesh, replica_sharding, shard_replicas
from .spatial import sharded_energy_fn

__all__ = ["HaloMD", "Mesh", "make_halo_spec", "make_mesh", "replica_sharding",
           "shard_replicas", "sharded_energy_fn"]
