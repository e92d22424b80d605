"""Shared machinery for track-to-pose distances (copy of
``openpifpaf_tpu/decoder/pose_distance/base.py``).

Every distance compares the candidate pose against one or more historical
poses of the track (offsets in ``track_frames``) and takes the best. The
history lookup and its gates — tracks stale by more than 12 frames, or
offsets reaching past the available history — are identical across
distances (the reference repeats them in each of
``decoder/pose_distance/{euclidean,oks,crafted}.py``), so they live here
and concrete distances only implement ``compare`` on two keypoint arrays.
"""

UNMATCHABLE = 1000.0
MAX_SKIPPED_FRAMES = 12


class PoseDistance:
    def __init__(self, *, track_frames=None):
        if track_frames is None:
            track_frames = [-1]
        assert all(offset < 0 for offset in track_frames)
        self.track_frames = track_frames
        self.valid_keypoints = None
        self.sigmas = None

    def __call__(self, frame_number, pose, track, track_is_good):
        return min(self.distance(frame_number, pose, track, track_is_good,
                                 offset)
                   for offset in self.track_frames)

    def _history(self, frame_number, track, offset):
        """The track's pose at history ``offset``, or None when gated.

        Offsets count back from the *current* frame, so a track that
        skipped frames has its effective offset shifted forward."""
        skipped = frame_number - track.frame_pose[-1][0] - 1
        if skipped > MAX_SKIPPED_FRAMES:
            return None, skipped
        offset += skipped
        if offset > -1 or len(track.frame_pose) < -offset:
            return None, skipped
        return track.frame_pose[offset][1], skipped

    def distance(self, frame_number, pose, track, track_is_good, offset=-1):
        reference, skipped = self._history(frame_number, track, offset)
        if reference is None:
            return UNMATCHABLE
        return self.compare(
            pose.data[self.valid_keypoints],
            reference.data[self.valid_keypoints],
            pose=pose, track=track, track_is_good=track_is_good,
            used_history=offset + skipped)

    def compare(self, kps, kps_ref, **context):
        raise NotImplementedError
