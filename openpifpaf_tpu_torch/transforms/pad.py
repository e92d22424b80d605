"""Padding transforms (reference ``transforms/pad.py:15-110``)."""

import copy
import math

import numpy as np
import PIL.ImageOps

from . import normalize
from .preprocess import Preprocess


def _pad_image(image, ltrb, fill):
    return PIL.ImageOps.expand(
        image, border=(ltrb[0], ltrb[1], ltrb[2], ltrb[3]), fill=fill)


def _apply_pad(image, anns, meta, target_w, target_h, fill):
    meta = copy.deepcopy(meta)
    anns = copy.deepcopy(anns)

    w, h = image.size
    left = max(0, int((target_w - w) / 2.0))
    top = max(0, int((target_h - h) / 2.0))
    right = max(0, target_w - w - left)
    bottom = max(0, target_h - h - top)
    ltrb = (left, top, right, bottom)

    image = _pad_image(image, ltrb, fill)
    for ann in anns:
        ann['keypoints'][:, 0] += ltrb[0]
        ann['keypoints'][:, 1] += ltrb[1]
        ann['bbox'][0] += ltrb[0]
        ann['bbox'][1] += ltrb[1]

    meta['offset'] -= np.asarray(ltrb[:2], dtype=float)
    meta['valid_area'][:2] += np.asarray(ltrb[:2], dtype=float)
    return image, anns, meta


class CenterPad(Preprocess):
    """Pad to a square of the given size with random gray fill."""

    def __init__(self, target_size):
        if isinstance(target_size, int):
            target_size = (target_size, target_size)
        self.target_size = target_size

    def __call__(self, image, anns, meta):
        fill_value = int(np.random.randint(0, 255))
        return _apply_pad(image, anns, meta,
                          self.target_size[0], self.target_size[1],
                          (fill_value, fill_value, fill_value))


class CenterPadTight(Preprocess):
    """Pad to the next multiple-of-``multiple`` + 1 (ImageNet-mean fill)."""

    def __init__(self, multiple):
        self.multiple = multiple

    def __call__(self, image, anns, meta):
        w, h = image.size
        target_w = math.ceil((w - 1) / self.multiple) * self.multiple + 1
        target_h = math.ceil((h - 1) / self.multiple) * self.multiple + 1
        return _apply_pad(image, anns, meta, target_w, target_h,
                          normalize.IMAGENET_MEAN_U8)


class SquarePad(Preprocess):
    """Center-pad to a square of the image's long edge
    (reference ``transforms/pad.py:113-116``)."""

    def __call__(self, image, anns, meta):
        center_pad = CenterPad(max(image.size))
        return center_pad(image, anns, meta)
