"""Object-keypoint-similarity distance (copy of
``openpifpaf_tpu/decoder/pose_distance/oks.py``): 110 * (1 - OKS), so a
perfect match costs 0 and total dissimilarity costs slightly more than
the euclidean invisible penalty."""

import numpy as np

from .base import PoseDistance, UNMATCHABLE


def _extent_scale(kps):
    confident = kps[kps[:, 2] > 0.0]
    spread_x = confident[:, 0].max() - confident[:, 0].min()
    spread_y = confident[:, 1].max() - confident[:, 1].min()
    return np.sqrt(spread_x * spread_y)


class Oks(PoseDistance):
    inflate = 1.0

    def compare(self, kps, kps_ref, **context):
        visible = (kps[:, 2] > 0.0) & (kps_ref[:, 2] > 0.0)
        if not np.any(visible):
            return UNMATCHABLE
        scale = max(1.0, 0.5 * (_extent_scale(kps)
                                + _extent_scale(kps_ref)))

        gaps = np.linalg.norm(kps_ref[:, :2] - kps[:, :2], axis=1)
        kappa = 2.0 * self.sigmas[self.valid_keypoints] * self.inflate
        similarity = np.exp(-0.5 * gaps ** 2 / (scale ** 2 * kappa ** 2))
        return 110.0 * (1.0 - np.mean(similarity[visible]))
