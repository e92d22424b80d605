"""Tracking model components (port of ``openpifpaf_tpu/models/tracking.py``).

A tracking model runs on interleaved frame pairs (2B, H, W, 3): frame 2i
is the primary (current) frame, frame 2i + 1 the other (previous) one.
The single-image heads see the primary frames, the Tcaf head both frames
of each pair. At eval the backbone runs once per frame and the caller
(``Predictor``) stacks [features of frame t, features of frame t - 1]
into a pair batch for ``heads``.
"""

import torch
from torch import nn
import torch.nn.functional as F

from .heads import CompositeField4
from .shell import Shell


class TBaseSingleImage(nn.Module):
    """A CompositeField4 on the primary frame of each pair."""

    def __init__(self, meta, in_features, tracking_pose_length=2):
        super().__init__()
        self.meta = meta
        self.tracking_pose_length = tracking_pose_length
        self.composite_field = CompositeField4(meta, in_features)

    def forward(self, x, train=False, generator=None):
        return self.composite_field(x[::self.tracking_pose_length], train,
                                    generator)


class Tcaf(nn.Module):
    """Temporal CAF head: a 1x1 feature reduction to ``reduced_features``
    shared by both frames, the pair's features concatenated [primary,
    other], a 1x1 to twice that, then a CompositeField4. None for an odd
    batch (no pairs)."""

    def __init__(self, meta, in_features, tracking_pose_length=2,
                 reduced_features=512):
        super().__init__()
        self.meta = meta
        self.tracking_pose_length = tracking_pose_length
        self.feature_reduction = nn.Conv2d(in_features, reduced_features, 1)
        self.feature_compute = nn.Conv2d(2 * reduced_features,
                                         2 * reduced_features, 1)
        self.composite_field = CompositeField4(meta, 2 * reduced_features)

    def forward(self, x, train=False, generator=None):
        if x.shape[0] % 2 == 1:
            return None
        x = F.relu(self.feature_reduction(x))
        primary = x[::self.tracking_pose_length]
        other = x[1::self.tracking_pose_length]
        x = torch.cat([primary, other], dim=1)
        x = F.relu(self.feature_compute(x))
        return self.composite_field(x, train, generator)


class TrackingShell(Shell):
    """The Shell over interleaved frame-pair batches, with
    ``TBaseSingleImage`` and ``Tcaf`` heads: ``backbone(images, train)``
    gives each frame's features, ``heads(features, train=, head_mask=)``
    the fields of the pairs."""
