"""Track-to-pose distances for similarity-based tracking (copy of
``openpifpaf_tpu/decoder/pose_distance/``); shared history gating lives in
:mod:`.base`."""

from . import base, crafted, euclidean, oks

PoseDistance = base.PoseDistance
UNMATCHABLE = base.UNMATCHABLE
Crafted = crafted.Crafted
Euclidean = euclidean.Euclidean
Oks = oks.Oks

__all__ = ['PoseDistance', 'UNMATCHABLE', 'Crafted', 'Euclidean', 'Oks']
