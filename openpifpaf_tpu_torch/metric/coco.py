"""COCO metric (reference ``metric/coco.py:38-163``) backed by the
self-contained :mod:`cocoeval` implementation."""

import json
import logging
import zipfile

import numpy as np

from .base import Base
from .cocoeval import CocoEval, COCO_PERSON_SIGMAS

LOG = logging.getLogger(__name__)


class Coco(Base):
    text_labels_keypoints = ['AP', 'AP0.5', 'AP0.75', 'APM', 'APL',
                             'AR', 'AR0.5', 'AR0.75', 'ARM', 'ARL']
    #: the ten values of ``CocoEval.stats`` in bbox mode (the JAX package
    #: labels the last four 'ART1', 'ART10', 'AR', 'ARS')
    text_labels_bbox = ['AP', 'AP0.5', 'AP0.75', 'APS', 'APM', 'APL',
                        'AR', 'ARS', 'ARM', 'ARL']

    def __init__(self, gt_by_image_id=None, *, max_per_image=20,
                 category_ids=None, iou_type='keypoints',
                 keypoint_oks_sigmas=None):
        """gt_by_image_id: dict image_id -> list of COCO annotation dicts.
        When None, ground truth is taken from each call's ``ground_truth``."""
        if category_ids is None:
            category_ids = [1]
        self.category_ids = category_ids
        self.max_per_image = max_per_image
        self.iou_type = iou_type
        self.sigmas = (np.asarray(keypoint_oks_sigmas)
                       if keypoint_oks_sigmas is not None
                       else COCO_PERSON_SIGMAS)
        self.gt_by_image_id = gt_by_image_id

        self.predictions = []
        self.image_ids = []
        self.eval = CocoEval(iou_type=iou_type, sigmas=self.sigmas,
                             max_dets=max_per_image)
        self._gt_used = {}

    def _gt_annotations(self, image_id, ground_truth):
        if self.gt_by_image_id is not None:
            return self.gt_by_image_id.get(image_id, [])
        return ground_truth or []

    def accumulate(self, predictions, image_meta, *, ground_truth=None):
        image_id = image_meta['image_id']
        self.image_ids.append(image_id)

        predictions = sorted(predictions, key=lambda a: -a.score)
        if len(predictions) > self.max_per_image:
            predictions = predictions[:self.max_per_image]

        image_annotations = []
        for pred in predictions:
            pred_data = pred.json_data()
            pred_data['image_id'] = image_id
            pred_data['keypoints'] = list(np.round(
                np.asarray(pred_data.get('keypoints', [])), 2).astype(float)) \
                if 'keypoints' in pred_data else []
            self.predictions.append(pred_data)
            image_annotations.append(pred_data)

        gts_raw = self._gt_annotations(image_id, ground_truth)
        for category_id in self.category_ids:
            dets = []
            for p in image_annotations:
                if p.get('category_id', 1) != category_id:
                    continue
                d = {'score': p['score']}
                if self.iou_type == 'keypoints':
                    kps = np.asarray(p['keypoints']).reshape(-1, 3)
                    d['keypoints'] = kps
                    bbox = p.get('bbox', [0, 0, 0, 0])
                    d['bbox'] = bbox
                    d['area'] = bbox[2] * bbox[3]
                else:
                    d['bbox'] = p['bbox']
                    d['area'] = p['bbox'][2] * p['bbox'][3]
                dets.append(d)

            gts = []
            for g in gts_raw:
                if g.get('category_id', 1) != category_id:
                    continue
                kps = np.asarray(g.get('keypoints', []),
                                 dtype=np.float32).reshape(-1, 3)
                bbox = np.asarray(g.get('bbox', [0, 0, 0, 0]), dtype=np.float32)
                area = float(g.get('area', bbox[2] * bbox[3]))
                num_keypoints = int(np.count_nonzero(kps[:, 2] > 0)) \
                    if kps.size else 0
                ignore = bool(g.get('iscrowd', 0)) or (
                    self.iou_type == 'keypoints' and num_keypoints == 0)
                gts.append({
                    'keypoints': kps, 'bbox': bbox, 'area': area,
                    'ignore': ignore, 'iscrowd': bool(g.get('iscrowd', 0)),
                })

            if dets or gts:
                self.eval.add_image(category_id=category_id,
                                    image_id=image_id, dets=dets, gts=gts)

    def stats(self):
        stats_values = self.eval.stats()
        text_labels = (self.text_labels_keypoints
                       if self.iou_type == 'keypoints'
                       else self.text_labels_bbox[:len(stats_values)])
        return {
            'stats': stats_values,
            'text_labels': text_labels,
        }

    def write_predictions(self, filename, *, additional_data=None):
        mkdir_if_missing(filename)
        predictions = [
            {k: v for k, v in annotation.items()
             if k in ('image_id', 'category_id', 'keypoints', 'bbox', 'score')}
            for annotation in self.predictions
        ]
        with open(filename + '.pred.json', 'w') as f:
            json.dump(predictions, f)
        LOG.info('wrote %s.pred.json', filename)
        with zipfile.ZipFile(filename + '.zip', 'w') as myzip:
            myzip.write(filename + '.pred.json', arcname='predictions.json')
        LOG.info('wrote %s.zip', filename)

        if additional_data:
            with open(filename + '.pred_meta.json', 'w') as f:
                json.dump(additional_data, f)
            LOG.info('wrote %s.pred_meta.json', filename)


def mkdir_if_missing(filename):
    import os
    dirname = os.path.dirname(filename)
    if dirname:
        os.makedirs(dirname, exist_ok=True)
