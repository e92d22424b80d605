"""Pair-consistent center pad with camera-shift offset
(reference ``transforms/pair/pad.py``)."""

import copy

import numpy as np

from .. import normalize
from ..preprocess import Preprocess
from ..pad import _pad_image


class Pad(Preprocess):
    def __init__(self, target_size, max_shift=0):
        if isinstance(target_size, int):
            target_size = (target_size, target_size)
        self.target_size = target_size
        self.max_shift = max_shift

    def __call__(self, images, all_anns, metas):
        metas = copy.deepcopy(metas)
        all_anns = copy.deepcopy(all_anns)
        images = list(images)

        cam_shift = (np.random.rand(2) - 0.5) * 2.0 * self.max_shift
        for i, meta in enumerate(metas):
            images[i], all_anns[i], ltrb = self.center_pad(
                images[i], all_anns[i], cam_shift * meta.get('group_i', 1.0))
            meta['offset'] -= np.asarray(ltrb[:2], dtype=float)
            meta['valid_area'][:2] += np.asarray(ltrb[:2], dtype=float)

        return images, all_anns, metas

    def center_pad(self, image, anns, cam_shift):
        w, h = image.size
        left = int((self.target_size[0] - w) / 2.0 + cam_shift[0])
        top = int((self.target_size[1] - h) / 2.0 + cam_shift[1])
        left = max(0, min(left, self.target_size[0] - w))
        top = max(0, min(top, self.target_size[1] - h))
        left = max(0, left)
        top = max(0, top)

        right = max(0, self.target_size[0] - w - left)
        bottom = max(0, self.target_size[1] - h - top)
        ltrb = (left, top, right, bottom)

        image = _pad_image(image, ltrb, normalize.IMAGENET_MEAN_U8)
        for ann in anns:
            ann['keypoints'][:, 0] += ltrb[0]
            ann['keypoints'][:, 1] += ltrb[1]
            ann['bbox'][0] += ltrb[0]
            ann['bbox'][1] += ltrb[1]
        return image, anns, ltrb
