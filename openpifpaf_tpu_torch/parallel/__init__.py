"""Distribution (port of ``openpifpaf_tpu/parallel/``).

JAX expresses every parallel form through ``jax.sharding`` over a
``Mesh``; the port uses ``torch.distributed`` process groups and explicit
devices:

- :func:`initialize_multihost` initialises ``torch.distributed`` from
  torchrun's environment (NCCL on the card, gloo on the CPU);
- :func:`data_mesh` is the data axis: a list of devices and the process
  group of the ranks;
- :func:`grid_mesh` is the ``('data', 'space')`` mesh: images split along
  H over the space axis, whose halo exchanges and row plan are
  :mod:`.spatial` and whose module graph is :mod:`.spatial_model`;
- :func:`image_sharding`, :func:`field_sharding`, :func:`replicate`,
  :func:`local_batch_slice` and :func:`shard_batch` give each rank or
  device its part of a global tensor;
- :class:`ShardedForward` splits a forward batch over local devices, and
  each image's height over the space axis of a grid mesh;
- :func:`cross_rank_batch_norm` reduces BatchNorm statistics over the
  ranks of a DDP step, as JAX's sharded step does over the global batch.
"""

from .batch_norm import cross_rank_batch_norm
from .inference import ShardedForward
from .mesh import (DataMesh, GridMesh, data_mesh, field_sharding, grid_mesh,
                   image_sharding, initialize_multihost, local_batch_slice,
                   rank_mean, rank_seed, replicate, shard_batch,
                   shard_loader)

__all__ = [
    'DataMesh', 'GridMesh', 'ShardedForward', 'cross_rank_batch_norm',
    'data_mesh', 'field_sharding', 'grid_mesh', 'image_sharding',
    'initialize_multihost', 'local_batch_slice', 'rank_mean', 'rank_seed',
    'replicate', 'shard_batch', 'shard_loader',
]
