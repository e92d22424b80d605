"""Rotation augmentations (semantics of reference
``transforms/rotate.py:92-130``).

Square images rotating by exact multiples of 90° take the lossless
``np.rot90`` path; anything else goes through scipy's resampling rotation
with a random fill value. Keypoints, boxes and the valid area rotate
about the pixel-center of the frame.
"""

import copy
import logging
import math

import numpy as np
import PIL.Image

from .pad import CenterPad
from .preprocess import Preprocess
from .. import utils

LOG = logging.getLogger(__name__)

_QUARTER_TURNS = {90.0: 1, 180.0: 2, 270.0: 3}


def _rotated_pixels(image, angle):
    array = np.asarray(image)
    square = array.shape[0] == array.shape[1]
    if square and angle in _QUARTER_TURNS:
        array = np.rot90(array, _QUARTER_TURNS[angle])
    else:
        # imported here: scipy.ndimage takes a second to import, and every
        # process of the package imports this module
        try:
            import scipy.ndimage
        except ImportError:
            raise AssertionError(
                'scipy required for non-90-degree rotations') from None
        fill = int(np.random.randint(0, 255))
        array = scipy.ndimage.rotate(array, angle=angle, cval=fill,
                                     reshape=False)
    return PIL.Image.fromarray(array)


def _rotate_keypoints(xy, half_w, half_h, cangle, sangle):
    x_rel = xy[:, 0].copy() - half_w
    y_rel = xy[:, 1].copy() - half_h
    xy[:, 0] = half_w + cangle * x_rel + sangle * y_rel
    xy[:, 1] = half_h - sangle * x_rel + cangle * y_rel


def _clamped_valid_area(valid_area, w, h):
    corner = valid_area[:2] + valid_area[2:]
    corner[0] = np.clip(corner[0], 0, w - 1)
    corner[1] = np.clip(corner[1], 0, h - 1)
    valid_area[0] = np.clip(valid_area[0], 0, w - 1)
    valid_area[1] = np.clip(valid_area[1], 0, h - 1)
    valid_area[2:] = corner - valid_area[:2]


def rotate(image, anns, meta, angle):
    meta = copy.deepcopy(meta)
    anns = copy.deepcopy(anns)
    w, h = image.size

    assert meta['rotation']['angle'] == 0.0
    meta['rotation'].update(angle=angle, width=w, height=h)

    if angle != 0.0:
        image = _rotated_pixels(image, angle)

    cangle = math.cos(angle / 180.0 * math.pi)
    sangle = math.sin(angle / 180.0 * math.pi)
    for ann in anns:
        _rotate_keypoints(ann['keypoints'][:, :2],
                          (w - 1) / 2, (h - 1) / 2, cangle, sangle)
        ann['bbox'] = utils.rotate_box(ann['bbox'], w - 1, h - 1, angle)

    meta['valid_area'] = utils.rotate_box(meta['valid_area'],
                                          w - 1, h - 1, angle)
    _clamped_valid_area(meta['valid_area'], w, h)
    return image, anns, meta


def _prepad(image, anns, meta, angle):
    """Grow the canvas so the rotated content is not clipped."""
    if abs(angle) < 0.3:
        return image, anns, meta
    w, h = image.size
    cos_a = math.cos(abs(angle) * math.pi / 180.0)
    sin_a = math.sin(abs(angle) * math.pi / 180.0)
    padded = (int(w * cos_a + h * sin_a) + 1,
              int(h * cos_a + w * sin_a) + 1)
    return CenterPad(padded)(image, anns, meta)


class RotateBy90(Preprocess):
    def __init__(self, angle_perturbation=0.0, fixed_angle=None,
                 prepad=False):
        self.angle_perturbation = angle_perturbation
        self.fixed_angle = fixed_angle
        self.prepad = prepad

    def _sample_angle(self):
        if self.fixed_angle is not None:
            return self.fixed_angle
        quarter = int(np.random.rand() * 4.0) * 90.0
        jitter = (float(np.random.rand()) - 0.5) * 2.0
        return quarter + jitter * self.angle_perturbation

    def __call__(self, image, anns, meta):
        angle = self._sample_angle()
        if self.prepad:
            image, anns, meta = _prepad(image, anns, meta, angle)
        return rotate(image, anns, meta, angle)


class RotateUniform(Preprocess):
    def __init__(self, max_angle=30.0, prepad=True):
        self.max_angle = max_angle
        self.prepad = prepad

    def __call__(self, image, anns, meta):
        angle = (float(np.random.rand()) - 0.5) * 2.0 * self.max_angle
        if self.prepad:
            image, anns, meta = _prepad(image, anns, meta, angle)
        return rotate(image, anns, meta, angle)
