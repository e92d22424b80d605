"""Process groups, the data axis, batch sharding (port of
``openpifpaf_tpu/parallel/mesh.py``)."""

import dataclasses
import logging
import os
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

LOG = logging.getLogger(__name__)

#: the error of the spatial mesh, which is not ported
SPATIAL_NOT_PORTED = ('the (data, space) mesh (images sharded along H with '
                      'halo exchanges) is not yet ported to PyTorch '
                      '(ROADMAP A12(b))')


def initialize_multihost(device_type='cuda', *, init_method=None,
                         world_size=None, rank=None):
    """Initialise ``torch.distributed`` and return its default group, or
    None in a single process.

    Without arguments it reads torchrun's environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``); with ``init_method``
    (e.g. ``tcp://localhost:PORT``) it takes ``world_size`` and ``rank``
    as given. NCCL on ``device_type`` ``'cuda'``, gloo on ``'cpu'``. An
    initialised process keeps its group.
    """
    if dist.is_initialized():
        return dist.group.WORLD
    if init_method is None:
        if 'WORLD_SIZE' not in os.environ:
            LOG.debug('single process: torch.distributed not initialised')
            return None
        init_method = 'env://'
    backend = 'nccl' if device_type == 'cuda' else 'gloo'
    kwargs = {}
    if world_size is not None:
        kwargs = dict(world_size=world_size, rank=rank)
    dist.init_process_group(backend, init_method=init_method, **kwargs)
    LOG.info('torch.distributed (%s): rank %d of %d', backend,
             dist.get_rank(), dist.get_world_size())
    return dist.group.WORLD


@dataclasses.dataclass
class DataMesh:
    """The data axis: this process's devices and the ranks' group (None
    in a single process)."""
    devices: List[torch.device]
    group: Optional[object] = None


def _local_devices(n_devices, device_type):
    if device_type == 'cuda':
        available = torch.cuda.device_count() \
            if torch.cuda.is_available() else 0
        n = available if n_devices is None else n_devices
        if n > available:
            raise ValueError(f'{n} CUDA devices asked for, {available} '
                             'visible')
        return [torch.device('cuda', i) for i in range(n)]
    # the CPU counts as many devices as asked for, as JAX's host platform
    # does with --xla_force_host_platform_device_count
    return [torch.device(device_type)] * (n_devices or 1)


def data_mesh(n_devices=None, *, device_type='cuda', group=None):
    """The 1-D data axis over the first ``n_devices`` local devices (all
    visible CUDA devices by default) and ``group`` (default: the
    initialised default group, if any)."""
    if group is None and dist.is_initialized():
        group = dist.group.WORLD
    return DataMesh(_local_devices(n_devices, device_type), group)


def grid_mesh(n_devices=None, *, spatial=1, device_type='cuda'):
    """The data axis; a spatial axis (``spatial > 1``) raises."""
    if spatial > 1:
        raise NotImplementedError(f'grid_mesh(spatial={spatial}): '
                                  + SPATIAL_NOT_PORTED)
    return data_mesh(n_devices, device_type=device_type)


def image_sharding(mesh):
    raise NotImplementedError('image_sharding: ' + SPATIAL_NOT_PORTED)


def field_sharding(mesh):
    raise NotImplementedError('field_sharding: ' + SPATIAL_NOT_PORTED)


def _rank_and_size(group):
    if group is None and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def local_batch_slice(global_batch_size, group=None):
    """The slice of a global batch that this rank loads."""
    rank, size = _rank_and_size(group)
    if global_batch_size % size:
        raise ValueError(f'global batch {global_batch_size} not divisible '
                         f'by {size} ranks')
    per_rank = global_batch_size // size
    return slice(rank * per_rank, (rank + 1) * per_rank)


def shard_batch(batch, mesh):
    """This process's part of a global batch (a tensor, an array, or a
    list or tuple of them, split along dim 0), one part per local device
    of ``mesh``, each on its device: the rank's slice split evenly over
    the devices. Returns a list over the devices of the same structure."""
    def parts(x):
        x = torch.as_tensor(np.asarray(x)) if not torch.is_tensor(x) else x
        local = x[local_batch_slice(x.shape[0], mesh.group)]
        if local.shape[0] % len(mesh.devices):
            raise ValueError(f'batch of {local.shape[0]} not divisible by '
                             f'{len(mesh.devices)} devices')
        return [p.to(d) for p, d in zip(
            local.chunk(len(mesh.devices)), mesh.devices)]

    if isinstance(batch, (list, tuple)):
        per_item = [parts(x) for x in batch]
        return [type(batch)(p[i] for p in per_item)
                for i in range(len(mesh.devices))]
    return parts(batch)


def rank_mean(values, group):
    """The mean over the ranks of ``group`` of each scalar tensor of
    ``values`` (one all-reduce; None entries stay None, and every rank
    has them in the same places)."""
    present = [v for v in values if v is not None]
    if not present:
        return list(values)
    stacked = torch.stack(present)
    dist.all_reduce(stacked, group=group)
    means = iter(stacked / dist.get_world_size(group))
    return [next(means) if v is not None else None for v in values]


def shard_loader(loader, rank, world_size):
    """Make ``loader`` (a ``Loader``, or a ``MultiLoader`` of them) load
    shard ``rank`` of ``world_size``."""
    for one in getattr(loader, 'loaders', [loader]):
        one.shard_id = rank
        one.num_shards = world_size
    return loader


def rank_seed(seed, rank):
    """The augmentation seed of ``rank`` (the global ``np.random`` that
    the transforms draw from)."""
    return [seed, rank]
