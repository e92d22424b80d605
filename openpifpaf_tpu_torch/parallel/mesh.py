"""Process groups, the data axis, the ``('data', 'space')`` grid, batch
and row sharding (port of ``openpifpaf_tpu/parallel/mesh.py``)."""

import dataclasses
import logging
import os
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .spatial import SpaceAxis, split_rows

LOG = logging.getLogger(__name__)


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


@dataclasses.dataclass
class GridMesh:
    """The ``('data', 'space')`` mesh: ``spatial`` shards of each image's
    height. This process holds ``devices``; across ``group``'s ranks
    (None: one process) rank r's device i is global device
    ``g = r * len(devices) + i``, at data index ``g // spatial`` and space
    index ``g % spatial``, as JAX reshapes its device list. This class is
    the one place that knows the layout: the Predictor, the Trainer and
    ``train.py`` read theirs from it. Raises ``ValueError`` when
    ``spatial`` does not divide the devices, as JAX does, or when a space
    axis would split a rank's devices unevenly."""
    devices: List[torch.device]
    spatial: int
    group: Optional[object] = None

    axis_names = ('data', 'space')

    def __post_init__(self):
        if self.n_devices % self.spatial:
            raise ValueError(f'{self.n_devices} devices not divisible by '
                             f'spatial={self.spatial}')
        per_rank = len(self.devices)
        if per_rank % self.spatial and self.spatial % per_rank:
            raise ValueError(f'spatial={self.spatial} neither divides nor '
                             f'is a multiple of the {per_rank} devices of '
                             'a rank')

    @property
    def rank(self):
        return _rank_and_size(self.group)[0]

    @property
    def n_devices(self):
        return len(self.devices) * _rank_and_size(self.group)[1]

    @property
    def shape(self):
        """(data, space)."""
        return self.n_devices // self.spatial, self.spatial

    def cells(self):
        """``(data, space)`` of each local device."""
        base = self.rank * len(self.devices)
        return [divmod(base + i, self.spatial)
                for i in range(len(self.devices))]

    def space_axes(self, group=None):
        """``(data index, SpaceAxis)`` of each data index that this
        process holds shards of. A space axis that spans ranks reaches
        their shards through point-to-point messages on ``group``
        (default: the default group), which holds ``self.group``'s
        ranks."""
        by_data = {}
        for device, (d, s) in zip(self.devices, self.cells()):
            by_data.setdefault(d, []).append((s, device))
        per_rank = len(self.devices)
        axes = []
        for d, shards in sorted(by_data.items()):
            owners = None
            if len(shards) < self.spatial:
                ranks = dist.get_process_group_ranks(
                    self.group or dist.group.WORLD)
                owners = tuple(ranks[(d * self.spatial + s) // per_rank]
                               for s in range(self.spatial))
            axes.append((d, SpaceAxis(
                self.spatial, tuple(s for s, _ in shards),
                tuple(device for _, device in shards), owners, group)))
        return axes


def grid_mesh(n_devices=None, *, spatial=1, device_type='cuda',
              devices=None):
    """The 2-D ``('data', 'space')`` mesh over ``n_devices`` local devices
    (all visible CUDA devices by default) and the ranks of the initialised
    default group: images split along H over ``spatial`` devices, batches
    over the rest. ``devices`` lists the local devices instead, one of
    them possibly more than once (several shards on one card).
    ``spatial=1`` is the data axis (:class:`DataMesh`). Raises
    ``ValueError`` as :class:`GridMesh` does."""
    if devices is None:
        devices = _local_devices(n_devices, device_type)
    group = dist.group.WORLD if dist.is_initialized() else None
    if spatial <= 1:
        return DataMesh(list(devices), group)
    return GridMesh(list(devices), spatial, group)


@dataclasses.dataclass
class Sharding:
    """How a tensor is split over a mesh: ``batch_dim`` over the data
    axis, ``row_dim`` over the space axis (None: not split)."""
    mesh: object
    batch_dim: Optional[int] = None
    row_dim: Optional[int] = None

    def shard(self, x):
        """This process's part of the whole tensor ``x`` on each of its
        devices (a list over ``mesh.devices``)."""
        mesh = self.mesh
        if isinstance(mesh, GridMesh):
            (n_data, n_space), cells = mesh.shape, mesh.cells()
        else:
            rank, size = _rank_and_size(mesh.group)
            n_data, n_space = size * len(mesh.devices), 1
            cells = [(rank * len(mesh.devices) + i, 0)
                     for i in range(len(mesh.devices))]
        parts = []
        for device, (d, s) in zip(mesh.devices, cells):
            part = x
            if self.batch_dim is not None:
                if x.shape[self.batch_dim] % n_data:
                    raise ValueError(f'batch of {x.shape[self.batch_dim]} '
                                     f'not divisible by {n_data}')
                part = part.chunk(n_data, self.batch_dim)[d]
            if self.row_dim is not None and n_space > 1:
                a, b = split_rows(x.shape[self.row_dim], n_space)[s]
                part = part.narrow(self.row_dim, a, b - a)
            parts.append(part.to(device))
        return parts


def image_sharding(mesh):
    """(B, H, W, C) images: batch over 'data', H over 'space' when the
    mesh has a spatial axis."""
    return Sharding(mesh, 0, 1 if isinstance(mesh, GridMesh) else None)


def field_sharding(mesh):
    """(B, F, C, fh, fw) fields and targets matching
    :func:`image_sharding`: fh over 'space'."""
    return Sharding(mesh, 0, 3 if isinstance(mesh, GridMesh) else None)


def replicate(mesh):
    """A tensor whole on every device."""
    return Sharding(mesh)


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
