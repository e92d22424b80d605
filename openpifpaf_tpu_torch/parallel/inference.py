"""A forward batch split over local devices (port of
``openpifpaf_tpu/parallel/inference.py``; the reference's
``torch.nn.DataParallel`` in its Predictor), and each image's height over
the space axis of a grid mesh."""

import copy

import torch

from . import spatial_model
from .mesh import GridMesh, data_mesh


class ShardedForward:
    """``fn(images (B, ...)) -> fields``: one replica of the forward on
    each device of ``mesh``, each running an equal part of the batch.

    ``model`` is copied to every device; ``forward(replica)`` builds the
    callable that a replica runs (default: the replica itself). A batch
    that the devices do not divide is padded by repeating its last image
    and the fields are trimmed back, as the JAX Predictor does. The parts
    are queued on every device before any is waited for, and the fields
    are gathered on the first device.

    On a :class:`.mesh.GridMesh` the batch is split over the data axis
    and each image's height over the space axis: ``spatial_forward(
    replicas)`` builds, from the replica of each shard's device, the
    callable ``fn(images, axis) -> field rows`` (default: the module
    graph, :func:`.spatial_model.shell_rows`), and each field is gathered
    along fh on the first device, where the decode runs on whole fields,
    as JAX's ``out_shardings=P('data')`` leaves them. A grid mesh serves
    in one process.
    """

    def __init__(self, model, *, mesh=None, forward=None,
                 spatial_forward=None):
        self.mesh = mesh or data_mesh()
        self.devices = list(self.mesh.devices)
        forward = forward or (lambda replica: replica)
        by_device = {}
        for device in self.devices:
            if device not in by_device:
                by_device[device] = copy.deepcopy(model).to(device)
        self.replicas = [by_device[d] for d in self.devices]
        if isinstance(self.mesh, GridMesh):
            if self.mesh.group is not None:
                raise ValueError('ShardedForward serves a grid mesh in one '
                                 'process, not over ranks')
            spatial_forward = spatial_forward or (
                lambda replicas: lambda images, axis: spatial_model.shell_rows(
                    replicas, images, axis))
            self._axes = [axis for _, axis in self.mesh.space_axes()]
            self._forwards = [spatial_forward([by_device[d]
                                               for d in axis.devices])
                              for axis in self._axes]
        else:
            self._axes = None
            fns = {d: forward(r) for d, r in by_device.items()}
            self._forwards = [fns[d] for d in self.devices]

    @property
    def n_devices(self):
        return len(self.devices)

    def __call__(self, images):
        true_batch = images.shape[0]
        n = len(self._forwards)
        pad = -true_batch % n
        if pad:
            images = torch.cat([images] + [images[-1:]] * pad)
        first = self.devices[0]
        if self._axes is not None:
            parts = [spatial_model.gather_fields(fn(part, axis), first)
                     for fn, part, axis in zip(self._forwards,
                                               images.chunk(n), self._axes)]
        else:
            parts = [
                fn(part.to(device, non_blocking=True))
                for fn, part, device in zip(self._forwards,
                                            images.chunk(n), self.devices)
            ]
        return tuple(
            torch.cat([p[i].to(first, non_blocking=True) for p in parts])
            [:true_batch]
            for i in range(len(parts[0])))
