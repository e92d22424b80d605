"""WholeBody 5-part evaluation (copy of
``openpifpaf_tpu/plugins/wholebody/metric.py``): separate OKS evaluations for
body / foot / face / hand / wholebody keypoint subsets."""

import logging

import numpy as np

from ...metric.base import Base
from ...metric.cocoeval import CocoEval

LOG = logging.getLogger(__name__)

PART_SLICES = {
    'body': slice(0, 17),
    'foot': slice(17, 23),
    'face': slice(23, 91),
    'hand': slice(91, 133),
    'wholebody': slice(0, 133),
}


class WholeBodyMetric(Base):
    def __init__(self, gt_by_image_id, *, sigmas, max_per_image=20):
        self.gt_by_image_id = gt_by_image_id
        self.sigmas = np.asarray(sigmas)
        self.max_per_image = max_per_image

        self.evals = {
            part: CocoEval(iou_type='keypoints',
                           sigmas=self.sigmas[sl],
                           max_dets=max_per_image)
            for part, sl in PART_SLICES.items()
        }

    def accumulate(self, predictions, image_meta, *, ground_truth=None):
        image_id = image_meta['image_id']
        predictions = sorted(predictions, key=lambda a: -a.score)
        predictions = predictions[:self.max_per_image]

        gts_raw = self.gt_by_image_id.get(image_id, [])

        for part, sl in PART_SLICES.items():
            dets = []
            for pred in predictions:
                kps = pred.data[sl].copy()
                bbox = pred.bbox()
                dets.append({
                    'score': pred.score,
                    'keypoints': kps,
                    'bbox': bbox,
                    'area': bbox[2] * bbox[3],
                })
            gts = []
            for g in gts_raw:
                kps = np.asarray(g.get('keypoints', []),
                                 dtype=np.float32).reshape(-1, 3)
                if kps.shape[0] < 133:
                    continue
                part_kps = kps[sl]
                bbox = np.asarray(g.get('bbox', [0, 0, 0, 0]),
                                  dtype=np.float32)
                n_vis = int(np.count_nonzero(part_kps[:, 2] > 0))
                gts.append({
                    'keypoints': part_kps,
                    'bbox': bbox,
                    'area': float(g.get('area', bbox[2] * bbox[3])),
                    'ignore': bool(g.get('iscrowd', 0)) or n_vis == 0,
                    'iscrowd': bool(g.get('iscrowd', 0)),
                })
            if dets or gts:
                self.evals[part].add_image(
                    category_id=1, image_id=image_id, dets=dets, gts=gts)

    def stats(self):
        values = []
        labels = []
        for part, ev in self.evals.items():
            part_stats = ev.stats()
            values.append(part_stats[0])   # AP
            values.append(part_stats[5])   # AR
            labels.append(f'AP_{part}')
            labels.append(f'AR_{part}')
        return {'stats': values, 'text_labels': labels}

    def write_predictions(self, filename, *, additional_data=None):
        LOG.warning('write_predictions not implemented for WholeBodyMetric')
