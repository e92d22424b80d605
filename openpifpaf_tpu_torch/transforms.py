"""Eval preprocessing on numpy HWC images (port of the transforms that
``openpifpaf_tpu.Predictor._build_preprocess`` chains).

Each transform maps ``(image, anns, meta) -> (image, anns, meta)``; images
are numpy arrays (H, W, 3), uint8 until :data:`EVAL_TRANSFORM` turns them
into normalized float32. Geometric steps update ``meta`` so that
``Annotation.inverse_transform(meta)`` maps predictions back to the
original image. PIL is imported only where an image is resampled.
"""

import copy
import math

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)
#: the mean as uint8 pixels: the pad fill colour that normalizes to ~0
IMAGENET_MEAN_U8 = tuple(int(round(float(m) * 255)) for m in IMAGENET_MEAN)


def _size(image):
    """(width, height) of an HWC array, like ``PIL.Image.size``."""
    return image.shape[1], image.shape[0]


class NormalizeAnnotations:
    """Canonical annotation arrays and the initial transform meta."""

    @staticmethod
    def normalize_annotations(anns):
        from .annotation import Base as AnnotationBase

        for ann in anns:
            if isinstance(ann, AnnotationBase):
                continue
            if 'keypoints' in ann:
                ann['keypoints'] = np.asarray(
                    ann['keypoints'], dtype=np.float32).reshape(-1, 3)
            if 'bbox' in ann:
                ann['bbox'] = np.asarray(ann['bbox'], dtype=np.float32)
            if 'bbox_original' not in ann and 'bbox' in ann:
                ann['bbox_original'] = np.copy(ann['bbox'])
            ann.setdefault('iscrowd', False)
        return anns

    def __call__(self, image, anns, meta):
        anns = self.normalize_annotations(anns)
        if meta is None:
            meta = {}
        w, h = _size(image)
        meta.setdefault('offset', np.array((0.0, 0.0)))
        meta.setdefault('scale', np.array((1.0, 1.0)))
        meta.setdefault('rotation',
                        {'angle': 0.0, 'width': None, 'height': None})
        meta.setdefault('valid_area', np.array((0.0, 0.0, w - 1, h - 1)))
        meta.setdefault('hflip', False)
        meta.setdefault('width_height', np.array((w, h)))
        return image, anns, meta


def resize_to(image, anns, meta, target_wh):
    """Bilinear resize (PIL) and the matching coordinate change.

    Keypoint coordinates are pixel-centre based, so the factor is
    (n_new - 1) / (n_old - 1) per axis, not the raw size ratio.
    """
    import PIL.Image

    meta = copy.deepcopy(meta)
    anns = copy.deepcopy(anns)
    w, h = _size(image)
    resampled = PIL.Image.fromarray(image).resize(
        target_wh, PIL.Image.BILINEAR)
    image = np.asarray(resampled)
    factors = np.array(((resampled.size[0] - 1) / (w - 1),
                        (resampled.size[1] - 1) / (h - 1)))

    for ann in anns:
        ann['keypoints'][:, :2] *= factors
        ann['bbox'][:2] *= factors
        ann['bbox'][2:] *= factors
    for field in ('offset', 'scale'):
        meta[field] = meta[field] * factors
    meta['valid_area'][:2] *= factors
    meta['valid_area'][2:] *= factors
    return image, anns, meta


class RescaleAbsolute:
    """Rescale so that the long edge has the given length."""

    def __init__(self, long_edge):
        self.long_edge = long_edge

    def __call__(self, image, anns, meta):
        edge = self.long_edge
        w, h = _size(image)
        ratio = edge / max(h, w)
        target = ((int(w * ratio), int(edge)) if h > w
                  else (int(edge), int(h * ratio)))
        return resize_to(image, anns, meta, target)


class CenterPadTight:
    """Pad to the next multiple of ``multiple`` plus one, centred, with the
    ImageNet-mean fill."""

    def __init__(self, multiple):
        self.multiple = multiple

    def __call__(self, image, anns, meta):
        meta = copy.deepcopy(meta)
        anns = copy.deepcopy(anns)

        w, h = _size(image)
        target_w = math.ceil((w - 1) / self.multiple) * self.multiple + 1
        target_h = math.ceil((h - 1) / self.multiple) * self.multiple + 1
        left = max(0, int((target_w - w) / 2.0))
        top = max(0, int((target_h - h) / 2.0))
        if (target_w, target_h) != (w, h):
            padded = np.empty((target_h, target_w, image.shape[2]),
                              dtype=image.dtype)
            padded[...] = np.asarray(IMAGENET_MEAN_U8, dtype=image.dtype)
            padded[top:top + h, left:left + w] = image
            image = padded

        for ann in anns:
            ann['keypoints'][:, 0] += left
            ann['keypoints'][:, 1] += top
            ann['bbox'][0] += left
            ann['bbox'][1] += top
        meta['offset'] -= np.asarray((left, top), dtype=float)
        meta['valid_area'][:2] += np.asarray((left, top), dtype=float)
        return image, anns, meta


class ToNumpy:
    def __call__(self, image, anns, meta):
        return np.asarray(image, dtype=np.float32) / 255.0, anns, meta


class NormalizeImage:
    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.mean = mean
        self.std = std

    def __call__(self, image, anns, meta):
        image = (np.asarray(image, dtype=np.float32) - self.mean) / self.std
        return image, anns, meta


class Compose:
    """Sequential composition; ``None`` entries are identity."""

    def __init__(self, preprocess_list):
        self.preprocess_list = preprocess_list

    def __call__(self, *args):
        for step in self.preprocess_list:
            if step is not None:
                args = step(*args)
        return args


EVAL_TRANSFORM = Compose([
    NormalizeAnnotations(),
    ToNumpy(),
    NormalizeImage(),
])
