"""Similarity-based tracker (copy of
``openpifpaf_tpu/decoder/pose_similarity.py``, with its
``--posesimilarity-distance euclidean4`` repaired).

Per frame: decode poses with the single-image CifCaf decoder, then solve
one rectangular assignment problem between active tracks and new poses.
The cost matrix is augmented with a block of constant-cost "lose this
track" rows so the Hungarian solver can leave a track unmatched (e.g.
under occlusion) whenever every real association costs more than 100.
"""

import argparse
import functools
import logging
import time

import numpy as np

from . import pose_distance
from .cifcaf import CifCaf
from .track_annotation import TrackAnnotation
from .track_base import TrackBase
from .. import headmeta

LOG = logging.getLogger(__name__)

#: cost of deliberately not matching a track this frame
LOSE_TRACK_COST = 100.0


class PoseSimilarity(TrackBase):
    distance_type = pose_distance.Euclidean

    def __init__(self, cif_meta, caf_meta, *, pose_generator=None):
        super().__init__()
        self.cif_meta = cif_meta
        self.caf_meta = caf_meta
        self.pose_generator = pose_generator or CifCaf(cif_meta, caf_meta)

        ignored = (('left_ear', 'right_ear')
                   if cif_meta.dataset == 'posetrack2018' else ())
        self.distance_function = self.distance_type()
        self.distance_function.valid_keypoints = [
            i for i, name in enumerate(cif_meta.keypoints)
            if name not in ignored]
        self.distance_function.sigmas = np.asarray(cif_meta.sigmas)

    @classmethod
    def cli(cls, parser: argparse.ArgumentParser):
        group = parser.add_argument_group('PoseSimilarity')
        group.add_argument('--posesimilarity-distance', default='euclidean',
                           choices=('crafted', 'euclidean', 'euclidean4',
                                    'oks'))
        group.add_argument('--posesimilarity-oks-inflate',
                           default=pose_distance.Oks.inflate, type=float)

    @classmethod
    def configure(cls, args: argparse.Namespace):
        # a partial, not JAX's lambda: a function stored on the class
        # binds as a method, so JAX's 'euclidean4' raises TypeError
        cls.distance_type = {
            'euclidean': pose_distance.Euclidean,
            'euclidean4': functools.partial(
                pose_distance.Euclidean, track_frames=[-1, -4, -8, -12]),
            'oks': pose_distance.Oks,
            'crafted': pose_distance.Crafted,
        }[args.posesimilarity_distance]
        pose_distance.Oks.inflate = args.posesimilarity_oks_inflate

    @classmethod
    def factory(cls, head_metas):
        # not auto-instantiated: TrackingPose is preferred when a Tcaf head
        # exists; use --decoder posesimilarity to request this tracker
        return []

    @classmethod
    def from_metas(cls, head_metas):
        single_image = (headmeta.TSingleImageCif, headmeta.Cif)
        single_image_caf = (headmeta.TSingleImageCaf, headmeta.Caf)
        return [
            cls(cif_meta, caf_meta)
            for cif_meta, caf_meta in zip(head_metas, head_metas[1:])
            if isinstance(cif_meta, single_image)
            and isinstance(caf_meta, single_image_caf)
        ]

    def _association_costs(self, poses):
        """(2T, P) cost matrix: real track rows on top, lose-track rows
        below."""
        n_tracks = len(self.active)
        cost = np.full((2 * n_tracks, len(poses)),
                       pose_distance.UNMATCHABLE)
        cost[n_tracks:, :] = LOSE_TRACK_COST
        for row, track in enumerate(self.active):
            good = self.track_is_good(track, self.frame_number)
            for col, pose in enumerate(poses):
                cost[row, col] = self.distance_function(
                    self.frame_number, pose, track, good)
        return cost

    def __call__(self, fields, *, initial_annotations=None):
        self.frame_number += 1
        start = time.perf_counter()
        self.prune_active(self.frame_number)

        poses = self.pose_generator(fields)
        cost = self._association_costs(poses)
        # imported here: scipy.optimize takes a second to import, and
        # every process of the package imports this module
        import scipy.optimize
        rows, cols = scipy.optimize.linear_sum_assignment(cost)

        extended = set(
            col for row, col in zip(rows, cols) if row < len(self.active))
        for row, col in zip(rows, cols):
            if row < len(self.active):
                self.active[row].add(self.frame_number, poses[col])
        for col, pose in enumerate(poses):
            if col not in extended:
                self.active.append(
                    TrackAnnotation().add(self.frame_number, pose))

        self.active = [t for t in self.active
                       if self.track_is_viable(t, self.frame_number)]

        LOG.debug('track time: %.3fs', time.perf_counter() - start)
        return self.annotations(self.frame_number)
