"""Ground truth -> Annotation objects for eval pipelines (copy of
``openpifpaf_tpu/transforms/toannotations.py``; semantics of reference
``transforms/toannotations.py:7-82``). Each converter consumes
the raw annotation dicts and emits typed annotation objects; crowd
regions get their own converter so metrics can treat them as ignore."""

import numpy as np

from ..annotation import Annotation, AnnotationCrowd, AnnotationDet
from .preprocess import Preprocess


class ToAnnotations(Preprocess):
    def __init__(self, converters):
        self.converters = converters

    def __call__(self, image, anns, meta):
        converted = []
        for converter in self.converters:
            converted.extend(converter(anns))
        return image, converted, meta


class ToKpAnnotations:
    def __init__(self, categories, keypoints_by_category,
                 skeleton_by_category):
        self.categories = categories
        self.keypoints_by_category = keypoints_by_category
        self.skeleton_by_category = skeleton_by_category

    def _convert(self, ann):
        cat = ann['category_id']
        out = Annotation(self.keypoints_by_category[cat],
                         self.skeleton_by_category[cat],
                         categories=self.categories)
        return out.set(ann['keypoints'], category_id=cat, fixed_score='',
                       fixed_bbox=ann.get('bbox'))

    def __call__(self, anns):
        return [self._convert(ann) for ann in anns
                if not ann['iscrowd']
                and np.any(ann['keypoints'][:, 2] > 0.0)]


class ToDetAnnotations:
    def __init__(self, categories):
        self.categories = categories

    def __call__(self, anns):
        out = []
        for ann in anns:
            if ann['iscrowd'] or not np.any(ann['bbox']):
                continue
            det = AnnotationDet(categories=self.categories)
            out.append(det.set(ann['category_id'], None, ann['bbox']))
        return out


class ToCrowdAnnotations:
    def __init__(self, categories):
        self.categories = categories

    def __call__(self, anns):
        out = []
        for ann in anns:
            if not ann['iscrowd']:
                continue
            crowd = AnnotationCrowd(categories=self.categories)
            out.append(crowd.set(ann.get('category_id', 1), ann['bbox']))
        return out
