"""Classification metric (copy of ``openpifpaf_tpu/metric/classification.py``):
treats the highest-scoring detection as the image label."""

import logging

import numpy as np

from .base import Base

LOG = logging.getLogger(__name__)


class Classification(Base):
    def __init__(self, categories):
        self.categories = categories
        self.predictions = []
        self.image_ids = []
        self.matched = []

    def accumulate(self, predictions, image_meta, *, ground_truth=None):
        self.image_ids.append(image_meta['image_id'])

        pred_category = None
        if predictions:
            best = max(predictions, key=lambda ann: ann.score or 0.0)
            pred_category = best.category_id

        gt_category = None
        if ground_truth:
            gt_category = ground_truth[0].category_id

        self.predictions.append(pred_category)
        self.matched.append(
            pred_category is not None and pred_category == gt_category)

    def stats(self):
        accuracy = (float(np.mean(self.matched)) if self.matched else 0.0)
        return {
            'stats': [accuracy],
            'text_labels': ['accuracy'],
        }

    def write_predictions(self, filename, *, additional_data=None):
        import json
        with open(filename + '.pred.json', 'w') as f:
            json.dump([
                {'image_id': i, 'category_id': p}
                for i, p in zip(self.image_ids, self.predictions)
            ], f)
