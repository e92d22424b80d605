"""A forward batch split over local devices (port of
``openpifpaf_tpu/parallel/inference.py``; the reference's
``torch.nn.DataParallel`` in its Predictor)."""

import copy

import torch

from .mesh import data_mesh


class ShardedForward:
    """``fn(images (B, ...)) -> fields``: one replica of the forward on
    each device of ``mesh``, each running an equal part of the batch.

    ``model`` is copied to every device; ``forward(replica)`` builds the
    callable that a replica runs (default: the replica itself). A batch
    that the devices do not divide is padded by repeating its last image
    and the fields are trimmed back, as the JAX Predictor does. The parts
    are queued on every device before any is waited for, and the fields
    are gathered on the first device.
    """

    def __init__(self, model, *, mesh=None, forward=None):
        self.mesh = mesh or data_mesh()
        self.devices = list(self.mesh.devices)
        forward = forward or (lambda replica: replica)
        self.replicas = []
        self._forwards = []
        for device in self.devices:
            replica = copy.deepcopy(model).to(device)
            self.replicas.append(replica)
            self._forwards.append(forward(replica))

    @property
    def n_devices(self):
        return len(self.devices)

    def __call__(self, images):
        true_batch = images.shape[0]
        n = self.n_devices
        pad = -true_batch % n
        if pad:
            images = torch.cat([images] + [images[-1:]] * pad)
        parts = [
            fn(part.to(device, non_blocking=True))
            for fn, part, device in zip(self._forwards, images.chunk(n),
                                        self.devices)
        ]
        first = self.devices[0]
        return tuple(
            torch.cat([p[i].to(first, non_blocking=True) for p in parts])
            [:true_batch]
            for i in range(len(parts[0])))
