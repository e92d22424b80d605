"""Hand-tuned distance (copy of
``openpifpaf_tpu/decoder/pose_distance/crafted.py``): center displacement plus
center-normalized shape difference plus penalties for short tracks, weak
poses and history lookbacks. Looks back up to 12 frames by default."""

import numpy as np

from .base import PoseDistance, UNMATCHABLE


class Crafted(PoseDistance):
    invisible_penalty = 110.0

    def __init__(self, *, track_frames=None):
        super().__init__(track_frames=track_frames
                         or [-1, -4, -8, -12])

    def compare(self, kps, kps_ref, *, pose, track, track_is_good,
                used_history):
        # anchor both poses at the centroid of their 3 most mutually
        # confident keypoints
        joint_conf = kps[:, 2] * kps_ref[:, 2]
        anchor = np.argsort(joint_conf)[::-1][:3]
        if kps[anchor[-1], 2] < 0.05 or kps_ref[anchor[-1], 2] < 0.05:
            return UNMATCHABLE
        center = np.mean(kps[anchor, :2], axis=0)
        center_ref = np.mean(kps_ref[anchor, :2], axis=0)

        shape_gaps = np.linalg.norm(
            (kps_ref[:, :2] - center_ref) - (kps[:, :2] - center), axis=1)
        shape_gaps = np.minimum(shape_gaps, self.invisible_penalty)
        hidden = (kps[:, 2] < 0.05) | (kps_ref[:, 2] < 0.05)
        shape_term = np.mean(np.where(hidden, self.invisible_penalty,
                                      shape_gaps))

        if len(track.frame_pose) < 4:
            track_penalty = 40.0
        elif len(track.frame_pose) < 8:
            track_penalty = 8.0
        else:
            track_penalty = 0.0
        if not track_is_good:
            track_penalty = max(track_penalty, 8.0)

        if pose.score < 0.2:
            pose_penalty = 40.0
        elif pose.score < 0.5:
            pose_penalty = 8.0
        else:
            pose_penalty = 0.0

        lookback_penalty = 40.0 if used_history < -1 else 0.0

        return (np.linalg.norm(center_ref - center) / 10.0
                + shape_term
                + track_penalty
                + pose_penalty
                + lookback_penalty)
