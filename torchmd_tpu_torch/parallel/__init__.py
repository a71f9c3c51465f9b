"""The device mesh of the port: replica and spatial sharding over
`torch.distributed`, one process per rank (`torchmd_tpu.parallel`'s
counterpart). `make_mesh` builds this rank's `Mesh` over an initialised
process group (`launch.Ranks` spawns one), `replica_sharding` gives the
replicas a rank owns, and `sharded_energy_fn` the batch- and row-sharded
energy that `train.ForceMatchingTrainer(mesh=)` differentiates.
`Integrator(mesh=..., shard="replica" | "spatial")` steps on it."""

from .mesh import Mesh, make_mesh, replica_sharding, shard_replicas
from .spatial import sharded_energy_fn

__all__ = ["Mesh", "make_mesh", "replica_sharding", "shard_replicas", "sharded_energy_fn"]
