"""Rescaling augmentations (semantics of reference
``transforms/scale.py:28-208``)."""

import copy
import logging

import numpy as np
import PIL.Image

from .preprocess import Preprocess

if not hasattr(PIL.Image, 'Resampling'):  # Pillow<9
    PIL.Image.Resampling = PIL.Image

LOG = logging.getLogger(__name__)


def resize_to(image, anns, meta, target_wh, resample=None):
    """Resize and propagate the coordinate change to annotations/meta.

    Keypoint coordinates are pixel-center based, so the factor is
    (n_new - 1) / (n_old - 1) per axis, not the raw size ratio.
    """
    meta = copy.deepcopy(meta)
    anns = copy.deepcopy(anns)
    w, h = image.size

    image = image.resize(target_wh,
                         resample if resample is not None
                         else PIL.Image.Resampling.BILINEAR)
    factors = np.array(((image.size[0] - 1) / (w - 1),
                        (image.size[1] - 1) / (h - 1)))

    for ann in anns:
        ann['keypoints'][:, :2] *= factors
        ann['bbox'][:2] *= factors
        ann['bbox'][2:] *= factors
    for field in ('offset', 'scale'):
        meta[field] = meta[field] * factors
    meta['valid_area'][:2] *= factors
    meta['valid_area'][2:] *= factors

    return image, anns, meta


class RescaleRelative(Preprocess):
    """Rescale by a factor sampled relative to the input size (uniform or
    log-uniform over ``scale_range``), optionally stretched anisotropically
    and normalized to an absolute reference long edge first."""

    def __init__(self, scale_range=(0.5, 1.0), *, resample=None,
                 absolute_reference=None, power_law=False,
                 stretch_range=None, fast=False):
        self.scale_range = scale_range
        self.resample = resample
        self.absolute_reference = absolute_reference
        self.power_law = power_law
        self.stretch_range = stretch_range
        self.fast = fast

    def _sample_factor(self):
        if not isinstance(self.scale_range, tuple):
            return self.scale_range
        if self.power_law:
            exponent = np.random.uniform(np.log2(self.scale_range[0]),
                                         np.log2(self.scale_range[1]))
            return 2 ** exponent
        return np.random.uniform(*self.scale_range)

    def __call__(self, image, anns, meta):
        factor = self._sample_factor()

        w, h = image.size
        if self.absolute_reference is not None:
            long_edge = max(w, h)
            w, h = (np.array((w, h), dtype=float)
                    * (self.absolute_reference / long_edge))
            if long_edge == image.size[0]:
                w = self.absolute_reference
            else:
                h = self.absolute_reference

        stretch = (np.random.uniform(*self.stretch_range)
                   if self.stretch_range is not None else 1.0)
        return resize_to(image, anns, meta,
                         (int(w * factor * stretch), int(h * factor)),
                         self.resample)


class RescaleAbsolute(Preprocess):
    """Rescale so the long edge has the given (or sampled) length."""

    def __init__(self, long_edge, *, fast=False, resample=None):
        self.long_edge = long_edge
        self.fast = fast
        self.resample = resample

    def __call__(self, image, anns, meta):
        edge = self.long_edge
        if isinstance(edge, (tuple, list)):
            edge = int(np.random.randint(int(edge[0]), int(edge[1])))

        w, h = image.size
        ratio = edge / max(h, w)
        target = ((int(w * ratio), int(edge)) if h > w
                  else (int(edge), int(h * ratio)))
        return resize_to(image, anns, meta, target, self.resample)


class ScaleMix(Preprocess):
    """Push all-small scenes up and all-large scenes down
    (reference ``transforms/scale.py:176-208``)."""

    def __init__(self, scale_threshold, *, upscale_factor=2.0,
                 downscale_factor=0.5, resample=None):
        self.scale_threshold = scale_threshold
        self.upscale_factor = upscale_factor
        self.downscale_factor = downscale_factor
        self.resample = resample

    def __call__(self, image, anns, meta):
        instance_scales = np.array([
            np.sqrt(ann['bbox'][2] * ann['bbox'][3])
            for ann in anns
            if (not ann.get('iscrowd', False)
                and np.any(ann['keypoints'][:, 2] > 0.0))
        ])
        if not instance_scales.shape[0]:
            return image, anns, meta

        if np.all(instance_scales > self.scale_threshold):
            factor = self.downscale_factor
        elif np.all(instance_scales < self.scale_threshold):
            factor = self.upscale_factor
        else:
            return image, anns, meta

        w, h = image.size
        return resize_to(image, anns, meta,
                         (int(w * factor), int(h * factor)), self.resample)
