"""Crowd-demotion filters (copy of ``openpifpaf_tpu/transforms/unclipped.py``:
``CrowdFilter``, ``MinSize``, ``UnclippedSides``, ``UnclippedArea``).

All of these turn unreliable ground-truth instances into crowd (ignore)
regions rather than dropping them: the instance still suppresses loss in
its area, it just stops contributing positive targets. They share one
base class that applies a per-annotation predicate.
"""

import copy

import numpy as np

from .preprocess import Preprocess


class CrowdFilter(Preprocess):
    """Demote annotations matching ``should_ignore`` to crowd regions."""

    def should_ignore(self, ann, meta):
        raise NotImplementedError

    def __call__(self, image, anns, meta):
        anns = copy.deepcopy(anns)
        for ann in anns:
            if self.should_ignore(ann, meta):
                ann['iscrowd'] = True
        return image, anns, meta


class MinSize(CrowdFilter):
    """Instances smaller than ``min_side`` px per side (reference
    ``transforms/minsize.py``)."""

    def __init__(self, min_side=1.0):
        self.min_side = min_side

    def should_ignore(self, ann, meta):
        return min(ann['bbox'][2], ann['bbox'][3]) <= self.min_side


class UnclippedSides(CrowdFilter):
    """Instance boxes hugging more than ``clipped_sides_okay`` edges of
    the valid area are probably truncated people."""

    def __init__(self, *, margin=10, clipped_sides_okay=2):
        self.margin = margin
        self.clipped_sides_okay = clipped_sides_okay

    def should_ignore(self, ann, meta):
        box = ann['bbox']
        area = meta['valid_area']
        edge_gaps = (
            box[0] - area[0],
            box[1] - area[1],
            (area[0] + area[2]) - (box[0] + box[2]),
            (area[1] + area[3]) - (box[1] + box[3]),
        )
        clipped = sum(1 for gap in edge_gaps if gap < self.margin)
        return clipped > self.clipped_sides_okay


class UnclippedArea(CrowdFilter):
    """Instances that lost most of their original area to augmentation
    crops."""

    def __init__(self, *, threshold=0.5):
        self.threshold = threshold

    def should_ignore(self, ann, meta):
        area_original = np.prod(ann['bbox_original'][2:])
        area_now = np.prod(ann['bbox'][2:] / meta['scale'])
        return not (area_original > 0.0
                    and area_now / area_original > self.threshold)
