"""COCO dataset reader (reference ``plugins/coco/dataset.py:16-145``).

Parses COCO-format JSON directly (pycocotools is not available in this
environment); provides image/annotation indexing, keypoint-count filtering
and class-aware sampling weights.
"""

import copy
import json
import logging
import os

import numpy as np
import PIL.Image

LOG = logging.getLogger(__name__)


class CocoIndex:
    """Minimal COCO-JSON index: images, annotations by image."""

    def __init__(self, ann_file):
        with open(ann_file, 'r') as f:
            data = json.load(f)
        self.images = {im['id']: im for im in data.get('images', [])}
        self.anns_by_image = {}
        for ann in data.get('annotations', []):
            self.anns_by_image.setdefault(ann['image_id'], []).append(ann)
        self.categories = {c['id']: c for c in data.get('categories', [])}

    def image_ids(self, category_ids=None):
        if not category_ids:
            return sorted(self.images.keys())
        ids = set()
        for image_id, anns in self.anns_by_image.items():
            if any(a.get('category_id') in category_ids for a in anns):
                ids.add(image_id)
        return sorted(ids)

    def annotations(self, image_id, category_ids=None):
        anns = self.anns_by_image.get(image_id, [])
        if category_ids:
            anns = [a for a in anns if a.get('category_id') in category_ids]
        return anns


class CocoDataset:
    """Images with keypoint/detection annotations."""

    def __init__(self, image_dir, ann_file, *, preprocess=None,
                 annotation_filter=False, min_kp_anns=0, category_ids=None):
        if category_ids is None:
            category_ids = []
        self.category_ids = category_ids
        self.image_dir = image_dir

        self.coco = CocoIndex(ann_file)
        self.ids = self.coco.image_ids(self.category_ids)
        if annotation_filter:
            self.filter_for_annotations(min_kp_anns=min_kp_anns)

        self.preprocess = preprocess

    def filter_for_annotations(self, *, min_kp_anns=0):
        LOG.info('filter for annotations (min kp=%d) ...', min_kp_anns)

        def filter_image(image_id):
            anns = self.coco.annotations(image_id, self.category_ids)
            anns = [ann for ann in anns if not ann.get('iscrowd')]
            if not anns:
                return False
            kp_anns = [ann for ann in anns
                       if 'keypoints' in ann and any(v > 0.0 for v in ann['keypoints'][2::3])]
            return len(kp_anns) >= min_kp_anns

        self.ids = [image_id for image_id in self.ids if filter_image(image_id)]
        LOG.info('... %d images remain', len(self.ids))

    def class_aware_sample_weights(self, max_multiple=10.0):
        """Class-aware sampling weights (dataset.py:59-84)."""
        ann_cats = [
            ann.get('category_id')
            for image_id in self.ids
            for ann in self.coco.annotations(image_id)
        ]
        cat_counts = {}
        for c in ann_cats:
            cat_counts[c] = cat_counts.get(c, 0) + 1

        weights = []
        for image_id in self.ids:
            anns = self.coco.annotations(image_id)
            if not anns:
                weights.append(1.0)
                continue
            w = max(1.0 / cat_counts[ann.get('category_id')] for ann in anns)
            weights.append(w)
        weights = np.asarray(weights)
        weights *= len(weights) / weights.sum()
        return np.clip(weights, 1.0 / max_multiple, max_multiple)

    def __getitem__(self, index):
        image_id = self.ids[index]
        image_info = self.coco.images[image_id]
        with open(os.path.join(self.image_dir, image_info['file_name']), 'rb') as f:
            image = PIL.Image.open(f).convert('RGB')

        anns = copy.deepcopy(self.coco.annotations(image_id, self.category_ids))
        for ann in anns:
            if 'keypoints' in ann:
                ann['keypoints'] = np.asarray(
                    ann['keypoints'], dtype=np.float32).reshape(-1, 3)
            if 'bbox' in ann:
                ann['bbox'] = np.asarray(ann['bbox'], dtype=np.float32)

        meta = {
            'dataset_index': index,
            'image_id': image_id,
            'file_name': image_info['file_name'],
            'local_file_path': os.path.join(self.image_dir,
                                            image_info['file_name']),
        }

        if self.preprocess is not None:
            image, anns, meta = self.preprocess(image, anns, meta)
        return image, anns, meta

    def __len__(self):
        return len(self.ids)
