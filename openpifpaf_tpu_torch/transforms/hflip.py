"""Horizontal flip (semantics of reference ``transforms/hflip.py:12-63``).

Mirrors pixels, keypoints, boxes and the valid area around the vertical
axis, and permutes left/right keypoint channels. The channel permutation
is precomputed once as an index array and applied as a single vectorized
assignment (the reference rebuilds it per annotation per call)."""

import copy
import logging

import numpy as np
import PIL.Image

from .preprocess import Preprocess

LOG = logging.getLogger(__name__)


def _mirrored_x(x, width):
    # pixel-center convention: column c maps to width - 1 - c
    return -x - 1.0 + width


class _HorizontalSwap:
    def __init__(self, keypoints, hflip):
        pairs = dict(hflip)
        for source, target in hflip.items():
            reverse = pairs.setdefault(target, source)
            assert reverse == source, \
                f'inconsistent hflip pair {source}<->{target}'
        self.permutation = np.array([
            keypoints.index(pairs[name]) if name in pairs else i
            for i, name in enumerate(keypoints)])

    def __call__(self, keypoints):
        if not len(keypoints):
            return keypoints  # a detection annotation has none to swap
        swapped = np.zeros(keypoints.shape)
        swapped[self.permutation] = keypoints
        return swapped


class HFlip(Preprocess):
    def __init__(self, keypoints, hflip):
        self.swap = _HorizontalSwap(keypoints, hflip)

    def __call__(self, image, anns, meta):
        meta = copy.deepcopy(meta)
        anns = copy.deepcopy(anns)
        w = image.size[0]

        image = image.transpose(PIL.Image.Transpose.FLIP_LEFT_RIGHT)
        for ann in anns:
            ann['keypoints'][:, 0] = _mirrored_x(ann['keypoints'][:, 0], w)
            if self.swap is not None and not ann['iscrowd']:
                ann['keypoints'] = self.swap(ann['keypoints'])
                meta['horizontal_swap'] = self.swap
            ann['bbox'][0] = _mirrored_x(ann['bbox'][0] + ann['bbox'][2], w)

        assert meta['hflip'] is False
        meta['hflip'] = True
        meta['valid_area'][0] = _mirrored_x(
            meta['valid_area'][0] + meta['valid_area'][2], w)
        return image, anns, meta
