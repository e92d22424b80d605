"""PoseTrack metric (copy of ``openpifpaf_tpu/plugins/posetrack/metric.py``).

The reference shells out to the external ``poseval`` toolkit for MOTA and
per-joint AP; neither the JAX package nor the port calls it. This metric
writes the per-sequence prediction JSONs in the PoseTrack submission
format, so that the official evaluation can be run on them, and reports
summary counts (images and predictions).
"""

import json
import logging
import os
from collections import defaultdict

from ...metric.base import Base

LOG = logging.getLogger(__name__)


class Posetrack(Base):
    def __init__(self, *, output_format='2018'):
        self.output_format = output_format
        self.predictions_by_file = defaultdict(list)
        self.images_by_file = defaultdict(list)
        self.n_images = 0
        self.n_annotations = 0

    def accumulate(self, predictions, image_meta, *, ground_truth=None):
        annotation_file = image_meta.get('annotation_file', 'unknown')
        image_id = image_meta.get('image_id')
        self.images_by_file[annotation_file].append({
            'id': image_id,
            'file_name': image_meta.get('file_name'),
        })
        self.n_images += 1

        for ann in predictions:
            keypoints = ann.data.copy()
            self.predictions_by_file[annotation_file].append({
                'image_id': image_id,
                'track_id': getattr(ann, 'id_', -1),
                'keypoints': keypoints.reshape(-1).tolist(),
                'scores': keypoints[:, 2].tolist(),
            })
            self.n_annotations += 1

    def stats(self):
        return {
            'stats': [float(self.n_images), float(self.n_annotations)],
            'text_labels': ['n_images', 'n_annotations'],
        }

    def write_predictions(self, filename, *, additional_data=None):
        os.makedirs(filename, exist_ok=True)
        for annotation_file, predictions in self.predictions_by_file.items():
            out_name = os.path.join(
                filename, os.path.basename(annotation_file))
            with open(out_name, 'w') as f:
                json.dump({
                    'images': self.images_by_file[annotation_file],
                    'annotations': predictions,
                }, f)
            LOG.info('wrote %s', out_name)
