"""TrackingPose: video pose tracking decoder (port of
``openpifpaf_tpu/decoder/tracking_pose.py``).

Tracking is folded into the pose decoder itself: the two frames are
treated as one synthetic 2x-keypoint skeleton (single-frame skeleton plus
one cross-frame edge per joint), the [CAF, TCAF] fields are concatenated,
and the previous frame's poses are injected as initial annotations in the
*past* half of the skeleton. The device decoder then grows each track
into the current frame like any other pose; brand-new people emerge from
ordinary seeds. The [CAF, TCAF] concatenation stays on the fields'
device.

The cross-frame edges name joints of the second frame, beyond the 17 CIF
fields: the CifHr rescoring of those edges reads the last field, as JAX's
clamping gather does (``ops/caf_scored.py``).
"""

import argparse
import logging
import time

import numpy as np
import torch

from .cifcaf import CifCaf
from .track_annotation import TrackAnnotation
from .track_base import TrackBase
from .. import headmeta
from ..annotation import Annotation

LOG = logging.getLogger(__name__)


def _two_frame_metas(cif_meta, caf_meta, n_frames):
    """Synthetic Cif/Caf metas over the concatenated keypoint set."""
    keypoints = list(cif_meta.keypoints) * n_frames
    sigmas = list(cif_meta.sigmas) * n_frames
    n_kp = len(cif_meta.keypoints)
    cross_edges = [
        (joint + 1, joint + 1 + frame * n_kp)
        for frame in range(1, n_frames)
        for joint in range(n_kp)
    ]

    tracking_cif = headmeta.Cif(
        'tracking_cif', cif_meta.dataset,
        keypoints=keypoints, sigmas=sigmas, pose=None)
    tracking_caf = headmeta.Caf(
        'tracking_caf', caf_meta.dataset,
        keypoints=keypoints, sigmas=sigmas,
        skeleton=list(caf_meta.skeleton) + cross_edges, pose=None)
    for meta, like, head_index in ((tracking_cif, cif_meta, 0),
                                   (tracking_caf, caf_meta, 1)):
        meta.head_index = head_index
        meta.base_stride = like.base_stride
        meta.upsample_stride = like.upsample_stride
    return tracking_cif, tracking_caf


class _OccupancyGrid:
    """Host-side occupancy at ``reduction``-x downsampling (the decoder's
    Occupancy semantics for cross-track suppression)."""

    def __init__(self, n_fields, height, width, reduction=2.0,
                 min_scale=4.0):
        self.reduction = reduction
        self.min_span = min_scale / reduction
        self.grid = np.zeros((n_fields,
                              int(height / reduction) + 1,
                              int(width / reduction) + 1), dtype=bool)

    def mark(self, field, x, y, sigma):
        x, y = x / self.reduction, y / self.reduction
        span = max(self.min_span, sigma / self.reduction)
        gh, gw = self.grid.shape[1:]
        x0 = int(np.clip(int(x - span), 0, gw - 1))
        y0 = int(np.clip(int(y - span), 0, gh - 1))
        x1 = int(np.clip(int(x + span), x0 + 1, gw))
        y1 = int(np.clip(int(y + span), y0 + 1, gh))
        self.grid[field, y0:y1, x0:x1] = True

    def taken(self, field, x, y):
        if field >= self.grid.shape[0]:
            return True
        gh, gw = self.grid.shape[1:]
        xi = int(np.clip(int(x / self.reduction), 0, gw - 1))
        yi = int(np.clip(int(y / self.reduction), 0, gh - 1))
        return bool(self.grid[field, yi, xi])


class TrackingPose(TrackBase):
    cache_group = [0, -1]
    track_recovery = False
    single_seed = False
    nms_keypoint_threshold = 0.15

    def __init__(self, cif_meta: headmeta.TSingleImageCif,
                 caf_meta: headmeta.TSingleImageCaf,
                 tcaf_meta: headmeta.Tcaf, *, pose_generator=None):
        super().__init__()
        self.cif_meta = cif_meta
        self.caf_meta = caf_meta
        self.tcaf_meta = tcaf_meta
        self.n_keypoints = len(cif_meta.keypoints)

        self.invalid_keypoints = [
            i for i, name in enumerate(cif_meta.keypoints)
            if name in ('left_ear', 'right_ear')
        ] if cif_meta.dataset == 'posetrack2018' else []

        self.tracking_cif_meta, self.tracking_caf_meta = _two_frame_metas(
            cif_meta, caf_meta, len(self.cache_group))
        self.pose_generator = pose_generator or CifCaf(
            self.tracking_cif_meta, self.tracking_caf_meta)

    @classmethod
    def cli(cls, parser: argparse.ArgumentParser):
        group = parser.add_argument_group('trackingpose decoder')
        group.add_argument('--trackingpose-track-recovery', default=False,
                           action='store_true')
        group.add_argument('--trackingpose-single-seed', default=False,
                           action='store_true')

    @classmethod
    def configure(cls, args: argparse.Namespace):
        cls.track_recovery = args.trackingpose_track_recovery
        cls.single_seed = args.trackingpose_single_seed

    @classmethod
    def factory(cls, head_metas):
        triplets = zip(head_metas, head_metas[1:], head_metas[2:])
        return [
            cls(cif_meta, caf_meta, tcaf_meta)
            for cif_meta, caf_meta, tcaf_meta in triplets
            if (isinstance(cif_meta, headmeta.TSingleImageCif)
                and isinstance(caf_meta, headmeta.TSingleImageCaf)
                and isinstance(tcaf_meta, headmeta.Tcaf))
        ]

    def _seed_annotation(self, track):
        """Two-frame annotation with the track's recent poses in the past
        slots (slot 0, the current frame, stays empty for the decoder to
        fill)."""
        seed = Annotation(self.tracking_cif_meta.keypoints,
                          self.tracking_caf_meta.skeleton)
        seed.id_ = track.id_
        for slot, frame_offset in enumerate(self.cache_group[1:], start=1):
            past = track.pose(self.frame_number + frame_offset)
            if past is None:
                continue
            block = slice(self.n_keypoints * slot,
                          self.n_keypoints * (slot + 1))
            seed.data[block] = past.data
            seed.joint_scales[block] = past.joint_scales

        if self.single_seed:
            weaker = seed.data[:, 2] < np.amax(seed.data[:, 2])
            seed.data[weaker] = 0.0
            seed.joint_scales[weaker] = 0.0
        seed.data[seed.data[:, 2] < 0.05] = 0.0
        return seed if np.any(seed.data[:, 2] > 0.0) else None

    def soft_nms(self, tracks, frame_number):
        """Occupancy-based cross-track suppression
        (reference tracking_pose.py:118-162)."""
        current = [(t, t.pose(frame_number)) for t in tracks]
        current = [(t, pose) for t, pose in current if pose is not None]
        if not tracks:
            return

        for _, pose in current:
            pose.data[pose.data[:, 2] < self.nms_keypoint_threshold] = 0.0
            if self.invalid_keypoints:
                pose.data[self.invalid_keypoints] = 0.0

        latest = [t.frame_pose[-1][1].data for t in tracks]
        grid_w = max(1, int(max(np.max(d[:, 0]) for d in latest) + 1))
        grid_h = max(1, int(max(np.max(d[:, 1]) for d in latest) + 1))
        occupancy = _OccupancyGrid(self.n_keypoints, grid_h, grid_w)

        by_strength = sorted(
            current,
            key=lambda tp: -tp[0].score(frame_number,
                                        current_importance=0.01))
        for _, pose in by_strength:
            for joint in np.flatnonzero(pose.data[:, 2]):
                x, y, _ = pose.data[joint]
                if occupancy.taken(joint, x, y):
                    pose.data[joint, 2] = 0.0
                else:
                    occupancy.mark(joint, x, y, pose.joint_scales[joint])

        for _, pose in current:
            pose.data[pose.data[:, 2] < self.nms_keypoint_threshold] = 0.0

    def _recover_lost_tracks(self, lost, by_id):
        """Attach single-observation newcomers to the most recently lost
        track instead of starting fresh ids."""
        absorbed = set()
        for track in self.active:
            if not lost:
                break
            if len(track) > 1 or track.pose(self.frame_number) is None:
                continue
            recovered_id = max(lost.items(), key=lambda item: item[1])[0]
            del lost[recovered_id]
            by_id[recovered_id].add(self.frame_number,
                                    track.pose(self.frame_number))
            absorbed.add(track)
        self.active = [t for t in self.active if t not in absorbed]

    def __call__(self, fields, *, initial_annotations=None):
        self.frame_number += 1
        start = time.perf_counter()

        seeds = [seed for track in self.active
                 for seed in [self._seed_annotation(track)]
                 if seed is not None]
        seeds.sort(key=lambda ann: ann.bbox()[3], reverse=True)

        tracking_fields = [
            fields[self.cif_meta.head_index],
            torch.cat([
                torch.as_tensor(fields[self.caf_meta.head_index]),
                torch.as_tensor(fields[self.tcaf_meta.head_index]),
            ], dim=0),
        ]
        decoded = self.pose_generator(tracking_fields,
                                      initial_annotations=seeds)

        by_id = {t.id_: t for t in self.active}
        lost = {t.id_: t.frame_pose[-1][0] for t in self.active
                if t.frame_pose[-1][0] < self.frame_number - 1}

        for tracking_ann in decoded:
            frame_pose = Annotation(self.cif_meta.keypoints,
                                    self.caf_meta.skeleton)
            frame_pose.data[:] = tracking_ann.data[:self.n_keypoints]
            frame_pose.joint_scales = \
                tracking_ann.joint_scales[:self.n_keypoints]

            source_id = getattr(tracking_ann, 'id_', None)
            if source_id in by_id:
                by_id[source_id].add(self.frame_number, frame_pose)
            else:
                fresh = TrackAnnotation().add(self.frame_number, frame_pose)
                self.active.append(fresh)
                tracking_ann.id_ = fresh.id_

        self.soft_nms(self.active, self.frame_number)
        if self.track_recovery:
            self._recover_lost_tracks(lost, by_id)

        self.active = [t for t in self.active
                       if self.track_is_viable(t, self.frame_number)]

        LOG.debug('track time: %.3fs', time.perf_counter() - start)
        return self.annotations(self.frame_number)
