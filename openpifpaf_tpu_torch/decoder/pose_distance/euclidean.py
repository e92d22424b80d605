"""Mean keypoint displacement distance (copy of
``openpifpaf_tpu/decoder/pose_distance/euclidean.py``)."""

import numpy as np

from .base import PoseDistance


class Euclidean(PoseDistance):
    invisible_penalty = 110.0

    def compare(self, kps, kps_ref, **context):
        gaps = np.linalg.norm(kps_ref[:, :2] - kps[:, :2], axis=1)
        gaps = np.minimum(gaps, self.invisible_penalty)
        hidden = (kps[:, 2] < 0.05) | (kps_ref[:, 2] < 0.05)
        return float(np.mean(np.where(hidden, self.invisible_penalty,
                                      gaps)))
