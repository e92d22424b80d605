"""Misc transforms: Assert, Deinterlace, MultiScale, crowd imputation
(copy of ``openpifpaf_tpu/transforms/misc.py``; reference
``transforms/{assertion,deinterlace,multi_scale,impute}.py``)."""

import copy

import numpy as np
import PIL.Image

from .preprocess import Preprocess


class Assert(Preprocess):
    """Assert a predicate on (image, anns, meta) mid-pipeline."""

    def __init__(self, predicate, message='transform assertion failed'):
        self.predicate = predicate
        self.message = message

    def __call__(self, image, anns, meta):
        assert self.predicate(image, anns, meta), self.message
        return image, anns, meta


class Deinterlace(Preprocess):
    """Deinterlace by dropping every second row and column."""

    def __call__(self, image, anns, meta):
        anns = copy.deepcopy(anns)
        meta = copy.deepcopy(meta)

        w, h = image.size
        image = image.resize((w // 2, h // 2), PIL.Image.Resampling.NEAREST)

        for ann in anns:
            ann['keypoints'][:, :2] /= 2.0
            ann['bbox'] /= 2.0

        meta['offset'] /= 2.0
        meta['scale'] *= 2.0
        meta['valid_area'] /= 2.0
        return image, anns, meta


class MultiScale(Preprocess):
    """Produce multiple scaled versions of the input (test-time
    augmentation, reference ``transforms/multi_scale.py``)."""

    def __init__(self, preprocess_list):
        self.preprocess_list = preprocess_list

    def __call__(self, image, anns, meta):
        image_list, anns_list, meta_list = [], [], []
        for p in self.preprocess_list:
            this_image, this_anns, this_meta = p(
                copy.deepcopy(image), copy.deepcopy(anns),
                copy.deepcopy(meta))
            image_list.append(this_image)
            anns_list.append(this_anns)
            meta_list.append(this_meta)
        return image_list, anns_list, meta_list


class AddCrowdForIncompleteHead(Preprocess):
    """Annotations with visible shoulders but no visible head keypoints
    become crowd regions around the expected head area
    (reference ``transforms/impute.py``)."""

    head_indices = (0, 1, 2, 3, 4)
    shoulder_indices = (5, 6)

    def __call__(self, image, anns, meta):
        anns = copy.deepcopy(anns)

        extra_crowd_anns = []
        for ann in anns:
            if ann['iscrowd']:
                continue
            kps = ann['keypoints']
            if np.any(kps[list(self.head_indices), 2] > 0.0):
                continue
            shoulders = kps[list(self.shoulder_indices)]
            if not np.all(shoulders[:, 2] > 0.0):
                continue

            shoulder_center = np.mean(shoulders[:, :2], axis=0)
            shoulder_d = np.linalg.norm(
                shoulders[0, :2] - shoulders[1, :2])
            size = max(8.0, shoulder_d)
            extra_crowd_anns.append({
                'keypoints': np.zeros_like(kps),
                'bbox': np.array([
                    shoulder_center[0] - size / 2,
                    shoulder_center[1] - size,
                    size, size], dtype=np.float32),
                'iscrowd': True,
            })

        return image, anns + extra_crowd_anns, meta
