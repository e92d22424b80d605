"""Annotation objects: decoded poses in image coordinates (port of
``openpifpaf_tpu/annotation.py``: ``Base`` and ``Annotation``).

Mirrors the reference ``annotation.py:16-302`` API surface (``json_data``,
``inverse_transform``, score, bbox) so downstream consumers (metrics, JSON
output, painters) are drop-in compatible.
"""

import copy

import numpy as np


class Base:
    def json_data(self):
        raise NotImplementedError

    def inverse_transform(self, meta):
        raise NotImplementedError


class Annotation(Base):
    def __init__(self, keypoints, skeleton, *, score_weights=None,
                 category_id=1):
        self.keypoints = keypoints
        self.skeleton = skeleton
        self.category_id = category_id

        self.data = np.zeros((len(keypoints), 3), dtype=np.float32)
        self.joint_scales = np.zeros((len(keypoints),), dtype=np.float32)

        if score_weights is None:
            score_weights = np.ones((len(keypoints),), dtype=np.float32)
        self.score_weights = np.asarray(score_weights, dtype=np.float32)

    @property
    def score(self):
        """Weight-sorted confidence dot product (reference annotation.py:98-110)."""
        v = self.data[:, 2]
        order = np.argsort(v)[::-1]
        score_weights = self.score_weights
        return float(
            np.sum(np.sort(score_weights)[::-1] * v[order])
            / np.sum(score_weights)
        )

    def bbox(self):
        return self.bbox_from_keypoints(self.data, self.joint_scales)

    @staticmethod
    def bbox_from_keypoints(kps, joint_scales):
        m = kps[:, 2] > 0
        if not np.any(m):
            return np.array([0.0, 0.0, 0.0, 0.0])

        x = np.min(kps[:, 0][m] - joint_scales[m])
        y = np.min(kps[:, 1][m] - joint_scales[m])
        w = np.max(kps[:, 0][m] + joint_scales[m]) - x
        h = np.max(kps[:, 1][m] + joint_scales[m]) - y
        return np.array([x, y, w, h])

    def json_data(self, coordinate_digits=2):
        """Data ready for json dump, matching the reference output format."""
        keypoints = np.around(self.data.astype(np.float64), coordinate_digits)
        keypoints[:, 2] = np.around(keypoints[:, 2], 3)
        return {
            'keypoints': keypoints.reshape(-1).tolist(),
            'bbox': [round(float(c), coordinate_digits) for c in self.bbox()],
            'score': max(0.001, round(float(self.score), 3)),
            'category_id': int(self.category_id),
        }

    def inverse_transform(self, meta):
        """Back to original image coordinates through the ``offset`` and
        ``scale`` of the eval transforms' meta (the port's transforms
        neither rotate nor flip)."""
        ann = copy.deepcopy(self)
        ann.data[:, 0] += meta['offset'][0]
        ann.data[:, 1] += meta['offset'][1]

        ann.data[:, 0] = ann.data[:, 0] / meta['scale'][0]
        ann.data[:, 1] = ann.data[:, 1] / meta['scale'][1]

        if np.any(ann.joint_scales != 0):
            ann.joint_scales /= meta['scale'][0]
        return ann
