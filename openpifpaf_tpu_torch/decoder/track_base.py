"""Track lifecycle management (copy of
``openpifpaf_tpu/decoder/track_base.py``): which tracks stay active, which
are reported, id simplification, and crowd-region tagging. Every tracker
resets on the ``eval_reset`` signal."""

import argparse
import logging
from typing import List

import numpy as np

from .base import Decoder
from .track_annotation import TrackAnnotation
from ..signal_ import Signal

LOG = logging.getLogger(__name__)

#: frames a track may go unobserved before it is dropped
MAX_TRACK_AGE = 33


def _inside_polygon(x, y, poly_xy):
    """Ray-casting point-in-polygon over a closed (N+1, 2) vertex array."""
    x1, y1 = poly_xy[:-1, 0], poly_xy[:-1, 1]
    x2, y2 = poly_xy[1:, 0], poly_xy[1:, 1]
    spans_y = (np.minimum(y1, y2) <= y) & (np.maximum(y1, y2) >= y)
    with np.errstate(divide='ignore', invalid='ignore'):
        x_at_y = x1 + (x2 - x1) * (y - y1) / (y2 - y1)
    crossings = spans_y & (x_at_y < x)
    return bool(np.count_nonzero(crossings) % 2)


class TrackBase(Decoder):
    single_pose_threshold = 0.3
    multi_pose_threshold = 0.2
    multi_pose_n = 3
    minimum_threshold = 0.1
    simplify_good_ids = True

    def __init__(self):
        super().__init__()
        self.active: List[TrackAnnotation] = []
        self.frame_number = 0
        self.simplified_track_id_map = {}
        self.simplified_last_track_id = 0

        Signal.subscribe('eval_reset', self.reset)

    @classmethod
    def cli(cls, parser: argparse.ArgumentParser):
        group = parser.add_argument_group('Decoder for tracking')
        group.add_argument('--tr-single-pose-threshold',
                           default=cls.single_pose_threshold, type=float)
        group.add_argument('--tr-multi-pose-threshold',
                           default=cls.multi_pose_threshold, type=float)
        group.add_argument('--tr-multi-pose-n',
                           default=cls.multi_pose_n, type=float)
        group.add_argument('--tr-minimum-threshold',
                           default=cls.minimum_threshold, type=float)

    @classmethod
    def configure(cls, args: argparse.Namespace):
        cls.single_pose_threshold = args.tr_single_pose_threshold
        cls.multi_pose_threshold = args.tr_multi_pose_threshold
        cls.multi_pose_n = args.tr_multi_pose_n
        cls.minimum_threshold = args.tr_minimum_threshold

    def reset(self):
        self.active = []
        self.frame_number = 0
        self.simplified_track_id_map = {}
        self.simplified_last_track_id = 0

    def simplify_ids(self, ids):
        """Remap raw track ids to a compact 1..n numbering, stable within
        the sequence."""
        for id_ in ids:
            if id_ not in self.simplified_track_id_map:
                self.simplified_last_track_id += 1
                self.simplified_track_id_map[id_] = \
                    self.simplified_last_track_id
        return [self.simplified_track_id_map[id_] for id_ in ids]

    def _last_seen(self, track):
        return track.frame_pose[-1][0]

    def prune_active(self, frame_number):
        self.active = [
            t for t in self.active
            if frame_number - self._last_seen(t) <= MAX_TRACK_AGE
            and (frame_number - self._last_seen(t) == 1
                 or len(t.frame_pose) > 2)
        ]

    def annotations(self, frame_number):
        """Poses of the good tracks observed this frame, with (optionally
        simplified) track ids attached."""
        reported = [t for t in self.active
                    if self._last_seen(t) == frame_number
                    and self.track_is_good(t, frame_number)]
        if not reported:
            return []

        ids = [t.id_ for t in reported]
        if self.simplify_good_ids:
            ids = self.simplify_ids(ids)
        poses = [t.frame_pose[-1][1] for t in reported]
        for pose, id_ in zip(poses, ids):
            pose.id_ = id_
        return poses

    def tag_ignore_region(self, frame_number, gt_anns):
        """Mark poses whose confident keypoints all fall inside a crowd
        polygon; such poses never make a track 'good'."""
        crowd_polygons = []
        for ann in gt_anns:
            if not ann['iscrowd']:
                continue
            poly = np.asarray(ann['keypoints'][:, :2], dtype=float)
            crowd_polygons.append(np.concatenate([poly, poly[:1]], axis=0))

        def swallowed(pose, polygon):
            confident = np.argsort(pose.data[:, 2])[::-1][:3]
            return all(
                _inside_polygon(kp[0], kp[1], polygon)
                for kp in pose.data[confident] if kp[2] > 0.05)

        for track in self.active:
            if self._last_seen(track) != frame_number:
                continue
            pose = track.frame_pose[-1][1]
            pose.ignore_region = any(swallowed(pose, polygon)
                                     for polygon in crowd_polygons)

    def track_is_viable(self, track, frame_number):
        if frame_number > self._last_seen(track) + MAX_TRACK_AGE:
            return False
        return any(
            track.pose_score(frame_number - i) > self.multi_pose_threshold
            for i in range(MAX_TRACK_AGE))

    def track_is_good(self, track, frame_number):
        recently_ignored = any(
            getattr(track.pose(frame_number - i), 'ignore_region', False)
            for i in range(4))
        if recently_ignored:
            return False

        if not self.track_is_viable(track, frame_number):
            return False

        recent = [track.pose_score(frame_number - i) for i in range(6)]
        ever_single = any(s >= self.single_pose_threshold for s in recent)
        multi_hits = sum(1 for s in recent
                         if s > self.multi_pose_threshold)
        if not ever_single and multi_hits < self.multi_pose_n:
            return False

        assert self.minimum_threshold >= 0.0
        return track.pose_score(frame_number) > self.minimum_threshold
