"""Annotation normalization (reference ``transforms/annotations.py``).

Converts dataset dicts into the canonical working format: keypoints as
float arrays, bbox as float array, and initializes the meta dict that
tracks the cumulative geometric transform.
"""

import copy

import numpy as np

from .preprocess import Preprocess


class NormalizeAnnotations(Preprocess):
    @staticmethod
    def normalize_annotations(anns):
        from ..annotation import Base as AnnotationBase

        for ann in anns:
            if isinstance(ann, AnnotationBase):
                # already a converted annotation object
                # (reference transforms/annotations.py:19-21)
                continue
            # a detection annotation (COCO's instances files) has no
            # keypoints, which every geometric transform moves: it gets
            # none, as in OpenPifPaf (the JAX package raises KeyError)
            ann['keypoints'] = np.asarray(
                ann.get('keypoints', ()), dtype=np.float32).reshape(-1, 3)
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
        w, h = image.size
        meta.setdefault('offset', np.array((0.0, 0.0)))
        meta.setdefault('scale', np.array((1.0, 1.0)))
        meta.setdefault('rotation', {'angle': 0.0, 'width': None, 'height': None})
        meta.setdefault('valid_area', np.array((0.0, 0.0, w - 1, h - 1)))
        meta.setdefault('hflip', False)
        meta.setdefault('width_height', np.array((w, h)))
        return image, anns, meta


class AnnotationJitter(Preprocess):
    def __init__(self, epsilon=0.5):
        self.epsilon = epsilon

    def __call__(self, image, anns, meta):
        meta = copy.deepcopy(meta)
        anns = copy.deepcopy(anns)
        for ann in anns:
            keypoints_xy = ann['keypoints'][:, :2]
            sym_rnd_kp = (np.random.rand(*keypoints_xy.shape) - 0.5) * 2.0
            keypoints_xy += self.epsilon * sym_rnd_kp

            sym_rnd_bbox = (np.random.rand(4) - 0.5) * 2.0
            ann['bbox'] += 0.5 * self.epsilon * sym_rnd_bbox
        return image, anns, meta
