"""Mean-pixel-error metric for car keypoints (copy of
``openpifpaf_tpu/plugins/apollocar3d/metrics.py``): per-GT-keypoint nearest
prediction distance in an all-vs-all setting, raw and CPM-crop-scaled,
with a 10 px detection threshold."""

import logging

import numpy as np

from ...annotation import Annotation
from ...metric.base import Base

LOG = logging.getLogger(__name__)


def _average(values):
    return float(np.mean(values)) if values else 0.0


class MeanPixelError(Base):
    px_ref = 368  # CPM crop size in pixels

    def __init__(self):
        self.errors = []
        self.detections = []
        self.errors_scaled = []
        self.detections_scaled = []

    def accumulate(self, predictions, image_meta, *, ground_truth=None):
        errors, detections = [], []
        errors_scaled, detections_scaled = [], []

        for annotation in ground_truth or []:
            if not isinstance(annotation, Annotation):
                continue
            indices_gt = np.nonzero(annotation.data[:, 2] > 1.0)
            if indices_gt[0].size <= 3:
                continue
            gts = annotation.data[indices_gt, 0:2].squeeze()
            if annotation.fixed_bbox is None:
                continue
            width = float(annotation.fixed_bbox[2])
            height = float(annotation.fixed_bbox[3])
            if width <= 0.0 or height <= 0.0:
                continue
            scale = np.array([self.px_ref / width,
                              self.px_ref / height]).reshape(1, 2)

            for idx, gt in zip(indices_gt[0], gts):
                preds = np.array(
                    [p.data[idx] for p in predictions]).reshape(-1, 3)[:, 0:2]
                if preds.size <= 0:
                    continue
                i = np.argmin(np.linalg.norm(preds - gt, axis=1))
                dist = preds[i:i + 1] - gt
                d = float(np.linalg.norm(dist, axis=1)[0])
                d_scaled = float(np.linalg.norm(dist * scale, axis=1)[0])

                # prediction correct if error less than 10 pixels
                if d < 10:
                    errors.append(d)
                    detections.append(1)
                else:
                    detections.append(0)
                if d_scaled < 10:
                    errors_scaled.append(d)
                    detections_scaled.append(1)
                else:
                    detections_scaled.append(0)

        LOG.debug('mpe %s det-rate %s', _average(errors),
                  100 * _average(detections))
        self.errors.extend(errors)
        self.detections.extend(detections)
        self.errors_scaled.extend(errors_scaled)
        self.detections_scaled.extend(detections_scaled)

    def write_predictions(self, filename, *, additional_data=None):
        raise NotImplementedError

    def stats(self):
        return {
            'stats': [_average(self.errors), _average(self.errors_scaled),
                      100 * _average(self.detections),
                      100 * _average(self.detections_scaled)],
            'text_labels': ['Mean Pixel Error',
                            'Mean Pixel Error Scaled',
                            'Detection Rate [%]',
                            'Detection Rate Scaled[%]'],
        }
