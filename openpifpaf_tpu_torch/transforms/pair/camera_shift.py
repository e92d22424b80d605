"""Synthetic camera motion (semantics of reference
``transforms/pair/camera_shift.py``): translate a frame by a random
offset scaled by its ``group_i`` (frame 1 stays put, frame 2 moves),
filling exposed pixels with gray."""

import copy

import numpy as np
import PIL.Image

from ..preprocess import Preprocess


class CameraShift(Preprocess):
    def __init__(self, max_shift=100):
        self.max_shift = max_shift

    def __call__(self, image, anns, meta):
        meta = copy.deepcopy(meta)
        anns = copy.deepcopy(anns)

        shift = (np.random.rand(2) - 0.5) * 2 * self.max_shift
        shift *= meta.get('group_i', 1.0)

        image = image.transform(
            image.size, PIL.Image.Transform.AFFINE,
            (1.0, 0.0, shift[0], 0.0, 1.0, shift[1]),
            fillcolor=(127, 127, 127))

        for ann in anns:
            ann['keypoints'][:, :2] += shift
            ann['bbox'][:2] += shift
        meta['offset'] += shift
        meta['valid_area'][:2] += shift
        return image, anns, meta
