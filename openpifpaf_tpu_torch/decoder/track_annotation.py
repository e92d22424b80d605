"""A tracked person: the sequence of (frame, pose) observations plus
head-weighted scoring (copy of ``openpifpaf_tpu/decoder/track_annotation.py``).
Track ids come from the module's ``_fresh_ids`` counter."""

import itertools

import numpy as np

#: past-window length of the track score
SCORE_WINDOW = 12

_fresh_ids = itertools.count(1)


def _head_emphasis_weights(n_keypoints):
    """Keypoint score weights favoring the head (posetrack protocol):
    eyes dominate, ears are unannotated, body joints barely count."""
    weights = np.ones(n_keypoints)
    weights[1] = 3.0
    weights[2] = 5.0
    weights[5:] = 0.1
    weights[-2:] = 0.0
    return weights / np.sum(weights)


class TrackAnnotation:
    def __init__(self):
        self.frame_pose = []
        self.id_ = next(_fresh_ids)

    def __len__(self):
        return len(self.frame_pose)

    def add(self, frame_number, pose_annotation):
        self.frame_pose.append((frame_number, pose_annotation))
        return self

    def pose(self, frame_number):
        """The pose observed exactly at ``frame_number``, else None."""
        for frame_i, pose in reversed(self.frame_pose):
            if frame_i == frame_number:
                return pose
            if frame_i < frame_number:
                break
        return None

    def pose_score(self, frame_number):
        pose = self.pose(frame_number)
        if pose is None:
            return 0.0
        confidences = pose.data[:, 2]
        second_best = np.partition(confidences, -2)[-2]
        if second_best < 0.05:
            return 0.0

        pose.score_weights[:] = _head_emphasis_weights(len(confidences))
        return pose.score

    def score(self, frame_number, current_importance=1.0):
        past = sum(self.pose_score(frame_number - i)
                   for i in range(1, SCORE_WINDOW))
        now = current_importance * self.pose_score(frame_number)
        return (now + past) / (current_importance + SCORE_WINDOW - 1)
