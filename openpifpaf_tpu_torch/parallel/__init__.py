"""Data-parallel distribution (port of ``openpifpaf_tpu/parallel/``).

JAX expresses every parallel form through ``jax.sharding`` over a
``Mesh``; the port uses ``torch.distributed`` process groups and explicit
devices:

- :func:`initialize_multihost` initialises ``torch.distributed`` from
  torchrun's environment (NCCL on the card, gloo on the CPU);
- :func:`data_mesh` is the data axis: a list of devices and the process
  group of the ranks;
- :func:`local_batch_slice` and :func:`shard_batch` give each rank or
  device its part of a global batch;
- :class:`ShardedForward` splits a forward batch over local devices;
- :func:`cross_rank_batch_norm` reduces BatchNorm statistics over the
  ranks of a DDP step, as JAX's sharded step does over the global batch.

The ``('data', 'space')`` mesh (images sharded along H with halo
exchanges) is not ported: :func:`grid_mesh` with ``spatial > 1``,
:func:`image_sharding` and :func:`field_sharding` raise, naming ROADMAP
A12(b).
"""

from .batch_norm import cross_rank_batch_norm
from .inference import ShardedForward
from .mesh import (DataMesh, data_mesh, field_sharding, grid_mesh,
                   image_sharding, initialize_multihost, local_batch_slice,
                   rank_mean, rank_seed, shard_batch, shard_loader)

__all__ = [
    'DataMesh', 'ShardedForward', 'cross_rank_batch_norm', 'data_mesh',
    'field_sharding', 'grid_mesh', 'image_sharding', 'initialize_multihost',
    'local_batch_slice', 'rank_mean', 'rank_seed', 'shard_batch',
    'shard_loader',
]
