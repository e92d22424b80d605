"""Annotation objects: decoded poses / detections in image coordinates
(copy of ``openpifpaf_tpu/annotation.py``: ``Annotation``,
``AnnotationDet``, ``AnnotationCrowd``).

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
    def __init__(self, keypoints, skeleton, *, score_weights=None, categories=None,
                 category_id=1, suppress_score_index=None):
        self.keypoints = keypoints
        self.skeleton = skeleton
        self.score_weights = score_weights
        self.categories = categories
        self.category_id = category_id
        self.suppress_score_index = suppress_score_index

        self.data = np.zeros((len(keypoints), 3), dtype=np.float32)
        self.joint_scales = np.zeros((len(keypoints),), dtype=np.float32)
        self.fixed_score = None
        self.fixed_bbox = None
        #: track id of a tracked annotation (kept from the initial pose)
        self.id_ = None
        #: (jsi, jti, jsxyv, jtxyv) per committed joint, in commit order,
        #: and the (source, target) edges of the frontier at convergence,
        #: filled by a decode with ``export_decoding_order``
        self.decoding_order = []
        self.frontier_order = []

        if self.score_weights is None:
            self.score_weights = np.ones((len(keypoints),), dtype=np.float32)
        self.score_weights = np.asarray(self.score_weights, dtype=np.float32)
        if self.suppress_score_index is not None:
            self.score_weights[self.suppress_score_index] = 0.0

    def add(self, joint_i, xyv):
        self.data[joint_i] = xyv
        return self

    def set(self, data, joint_scales=None, *, category_id=1, fixed_score=None,
            fixed_bbox=None):
        self.data = np.asarray(data, dtype=np.float32)
        if joint_scales is not None:
            self.joint_scales = np.asarray(joint_scales, dtype=np.float32)
        else:
            self.joint_scales = np.zeros((len(self.data),), dtype=np.float32)
        self.category_id = category_id
        self.fixed_score = fixed_score
        self.fixed_bbox = fixed_bbox
        return self

    @property
    def category(self):
        if self.categories is None:
            return 'person'
        return self.categories[self.category_id - 1]

    @property
    def score(self):
        """Weight-sorted confidence dot product (reference annotation.py:98-110)."""
        if self.fixed_score is not None:
            return self.fixed_score

        v = self.data[:, 2]
        order = np.argsort(v)[::-1]
        # "max() to avoid strong negative bias for very small annotations"
        score_weights = self.score_weights
        return float(
            np.sum(np.sort(score_weights)[::-1] * v[order])
            / np.sum(score_weights)
        )

    def bbox(self):
        if self.fixed_bbox is not None:
            return self.fixed_bbox
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
        ann = copy.deepcopy(self)

        # rotation
        angle = -meta['rotation']['angle']
        if angle != 0.0:
            rw = meta['rotation']['width']
            rh = meta['rotation']['height']
            ann.data[:, :2] = _rotate_points(ann.data[:, :2], angle, rw, rh)

        ann.data[:, 0] += meta['offset'][0]
        ann.data[:, 1] += meta['offset'][1]

        ann.data[:, 0] = ann.data[:, 0] / meta['scale'][0]
        ann.data[:, 1] = ann.data[:, 1] / meta['scale'][1]

        if np.any(ann.joint_scales != 0):
            ann.joint_scales /= meta['scale'][0]

        if meta['hflip']:
            w = meta['width_height'][0]
            ann.data[:, 0] = -ann.data[:, 0] + (w - 1)
            if meta.get('horizontal_swap'):
                ann.data[:] = meta['horizontal_swap'](ann.data)

        return ann


class AnnotationDet(Base):
    def __init__(self, categories):
        self.categories = categories
        self.category_id = None
        self.score = None
        self.bbox = None

    def set(self, category_id, score, bbox):
        self.category_id = category_id
        self.score = score
        self.bbox = np.asarray(bbox)
        return self

    @property
    def category(self):
        return self.categories[self.category_id - 1]

    def json_data(self):
        return {
            'category_id': int(self.category_id),
            'category': self.category,
            'score': max(0.001, round(float(self.score), 3)),
            'bbox': [round(float(c), 2) for c in self.bbox],
        }

    def inverse_transform(self, meta):
        ann = copy.deepcopy(self)

        angle = -meta['rotation']['angle']
        if angle != 0.0:
            rw = meta['rotation']['width']
            rh = meta['rotation']['height']
            xy = np.array([
                [ann.bbox[0], ann.bbox[1]],
                [ann.bbox[0] + ann.bbox[2], ann.bbox[1] + ann.bbox[3]],
                [ann.bbox[0], ann.bbox[1] + ann.bbox[3]],
                [ann.bbox[0] + ann.bbox[2], ann.bbox[1]],
            ])
            xy = _rotate_points(xy, angle, rw, rh)
            x0, y0 = np.min(xy, axis=0)
            x1, y1 = np.max(xy, axis=0)
            ann.bbox = np.array([x0, y0, x1 - x0, y1 - y0])

        ann.bbox[0] += meta['offset'][0]
        ann.bbox[1] += meta['offset'][1]
        ann.bbox[0] /= meta['scale'][0]
        ann.bbox[1] /= meta['scale'][1]
        ann.bbox[2] /= meta['scale'][0]
        ann.bbox[3] /= meta['scale'][1]

        if meta['hflip']:
            w = meta['width_height'][0]
            ann.bbox[0] = -(ann.bbox[0] + ann.bbox[2]) + (w - 1)

        return ann


class AnnotationCrowd(Base):
    """Crowd region annotation (ignore region for evaluation)."""

    def __init__(self, categories):
        self.categories = categories
        self.category_id = None
        self.bbox = None

    def set(self, category_id, bbox):
        self.category_id = category_id
        self.bbox = np.asarray(bbox)
        return self

    @property
    def category(self):
        return self.categories[self.category_id - 1]

    def json_data(self):
        return {
            'category_id': int(self.category_id),
            'category': self.category,
            'iscrowd': 1,
            'bbox': [round(float(c), 2) for c in self.bbox],
            'score': 1.0,
        }

    def inverse_transform(self, meta):
        fake_det = AnnotationDet(self.categories)
        fake_det.set(self.category_id, 1.0, self.bbox)
        fake_det = fake_det.inverse_transform(meta)

        ann = copy.deepcopy(self)
        ann.bbox = fake_det.bbox
        return ann


def _rotate_points(xy, angle, width, height):
    cangle = np.cos(np.deg2rad(angle))
    sangle = np.sin(np.deg2rad(angle))
    xy = np.copy(xy)
    x_old = xy[:, 0].copy() - (width - 1) / 2
    y_old = xy[:, 1].copy() - (height - 1) / 2
    xy[:, 0] = (width - 1) / 2 + cangle * x_old + sangle * y_old
    xy[:, 1] = (height - 1) / 2 - sangle * x_old + cangle * y_old
    return xy
