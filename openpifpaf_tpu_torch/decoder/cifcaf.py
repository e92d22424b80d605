"""CifCaf decoder (port of ``openpifpaf_tpu/decoder/cifcaf.py`` and
``decoder/base.py``): CLI-configurable thresholds and budgets, the
adaptive two-tier decode and the tensor -> Annotation conversion.
"""

import argparse
import dataclasses
import logging
import time
from typing import List

import numpy as np
import torch

from .. import headmeta
from ..annotation import Annotation
from ..ops.decode_cifcaf import CifCafDecoderConfig, decode_cifcaf

LOG = logging.getLogger(__name__)


class CifCaf:
    # CLI-configurable statics (the JAX decoder's flags that the port has)
    keypoint_threshold = 0.15
    keypoint_threshold_rel = 0.5
    reverse_match = True
    instance_threshold = 0.15
    seed_threshold = 0.2
    keypoint_threshold_nms = 0.15
    cifhr_threshold = 0.3
    caf_score_th = 0.3
    connection_method = 'blend'
    n_seeds = 256
    n_poses = 96
    #: pose budget of the crowd tier (None: the auto-scaled budget)
    n_poses_crowd = None
    n_hr_cells = 256

    def __init__(self, cif_meta: headmeta.Cif, caf_meta: headmeta.Caf):
        self.cif_meta = cif_meta
        self.caf_meta = caf_meta
        self.skeleton = np.asarray(caf_meta.skeleton, dtype=np.int64)
        self.n_keypoints = len(cif_meta.keypoints)
        self.score_weights = cif_meta.score_weights
        self.last_decoder_time = 0.0
        #: indices of the images of the last batch re-decoded at the
        #: crowd tier
        self.last_escalated = []

        self.config = CifCafDecoderConfig(
            cifhr_threshold=self.cifhr_threshold,
            seed_threshold=self.seed_threshold,
            caf_score_th=self.caf_score_th,
            keypoint_threshold=self.keypoint_threshold,
            keypoint_threshold_rel=self.keypoint_threshold_rel,
            reverse_match=self.reverse_match,
            connection_method=self.connection_method,
            nms_instance_threshold=self.instance_threshold,
            nms_keypoint_threshold=self.keypoint_threshold_nms,
            n_seeds=self.n_seeds,
            n_poses=self.n_poses,
            n_hr_cells=self.n_hr_cells,
        )

    @classmethod
    def cli(cls, parser: argparse.ArgumentParser):
        group = parser.add_argument_group('CifCaf decoder')
        group.add_argument('--cif-th', default=cls.cifhr_threshold,
                           type=float, help='cif threshold')
        group.add_argument('--caf-th', default=cls.caf_score_th,
                           type=float, help='caf threshold')
        group.add_argument('--keypoint-threshold', type=float,
                           default=cls.keypoint_threshold,
                           help='filter keypoints by score')
        group.add_argument('--keypoint-threshold-rel', type=float,
                           default=cls.keypoint_threshold_rel,
                           help='filter keypoints by relative score')
        group.add_argument('--instance-threshold', type=float,
                           default=cls.instance_threshold,
                           help='filter instances by score')
        group.add_argument('--seed-threshold', type=float,
                           default=cls.seed_threshold)
        group.add_argument('--connection-method',
                           default=cls.connection_method,
                           choices=('blend', 'max'),
                           help='connection blending (cifcaf.cpp:32-113)')
        group.add_argument('--no-reverse-match', dest='reverse_match',
                           default=True, action='store_false')
        group.add_argument('--decoder-seeds', type=int, default=cls.n_seeds,
                           help='static seed budget of the decoder')
        group.add_argument('--decoder-poses', type=int, default=cls.n_poses,
                           help='static pose budget of the decoder')
        group.add_argument('--decoder-crowd-poses', type=int,
                           default=cls.n_poses_crowd,
                           help='pose budget of the crowd escalation tier')

    @classmethod
    def configure(cls, args: argparse.Namespace):
        cls.cifhr_threshold = args.cif_th
        cls.caf_score_th = args.caf_th
        cls.keypoint_threshold = args.keypoint_threshold
        cls.keypoint_threshold_rel = args.keypoint_threshold_rel
        cls.keypoint_threshold_nms = args.keypoint_threshold
        if args.seed_threshold < cls.keypoint_threshold:
            cls.keypoint_threshold = args.seed_threshold
        cls.instance_threshold = args.instance_threshold
        cls.seed_threshold = args.seed_threshold
        cls.connection_method = args.connection_method
        cls.reverse_match = args.reverse_match
        cls.n_seeds = args.decoder_seeds
        cls.n_poses = args.decoder_poses
        cls.n_poses_crowd = args.decoder_crowd_poses

    @classmethod
    def factory(cls, head_metas) -> List['CifCaf']:
        """Pair adjacent (Cif, Caf) metas."""
        return [
            cls(cif_meta, caf_meta)
            for cif_meta, caf_meta in zip(head_metas, head_metas[1:])
            if (isinstance(cif_meta, headmeta.Cif)
                and isinstance(caf_meta, headmeta.Caf))
        ]

    def _crowd_config(self):
        cfg = self.config.crowd()
        if self.n_poses_crowd:
            cfg = dataclasses.replace(cfg, n_poses=self.n_poses_crowd)
        return cfg

    def _decode(self, stride, cif, caf, crowd=False):
        return decode_cifcaf(
            cif, caf, stride=stride, skeleton=self.skeleton,
            config=self._crowd_config() if crowd else self.config,
            n_keypoints=self.n_keypoints)

    def _decode_adaptive(self, stride, args):
        """Fast-tier decode of the batch, then crowd-tier re-decode of the
        images that exceeded a budget. Returns numpy (poses, keep, order)."""
        *parts, overflow = self._decode(stride, *args)
        return self._escalate(stride, args, parts, overflow)

    def _escalate(self, stride, args, parts, overflow):
        """Re-decode each flagged image alone through the crowd tier and
        splice its rows in. Fast-tier outputs are padded along the pose
        axis to the crowd tier's budget; padded rows carry keep=False and
        sort last."""
        parts = [p.cpu().numpy() for p in parts]
        overflow = overflow.cpu().numpy()
        self.last_escalated = [int(b) for b in np.nonzero(overflow)[0]]
        if not overflow.any():
            return parts
        LOG.debug('decoder budget overflow on %d/%d images: crowd tier',
                  int(overflow.sum()), overflow.shape[0])
        crowd_rows = {}
        crowd_overflow = False
        for b in self.last_escalated:
            *crowd_parts, c_over = self._decode(
                stride, *(a[b:b + 1] for a in args), crowd=True)
            crowd_rows[b] = [p[0].cpu().numpy() for p in crowd_parts]
            crowd_overflow |= bool(c_over[0])
        if crowd_overflow:
            LOG.warning('decode budgets exceeded even at the crowd tier; '
                        'some instances may be missed')
        n_fast = parts[0].shape[1]
        n_crowd = next(iter(crowd_rows.values()))[0].shape[0]
        out = []
        for i, p in enumerate(parts):
            if n_crowd > n_fast:
                pad = [(0, 0), (0, n_crowd - n_fast)] + \
                    [(0, 0)] * (p.ndim - 2)
                p = np.pad(p, pad)
                if i == 2:  # order stays a permutation of range(n_crowd)
                    p[:, n_fast:] = np.arange(n_fast, n_crowd, dtype=p.dtype)
            else:
                p = p.copy()
            for b, rows in crowd_rows.items():
                p[b] = rows[i]
            out.append(p)
        return out

    def batch_decode(self, fields_batch):
        """fields_batch: list over head indices of (B, F, C, H, W) tensors.
        Returns one list of annotations per image."""
        cif = fields_batch[self.cif_meta.head_index]
        caf = fields_batch[self.caf_meta.head_index]
        cif, caf = (torch.as_tensor(f, dtype=torch.float32)
                    for f in (cif, caf))
        stride = self.cif_meta.stride
        assert stride == self.caf_meta.stride

        start = time.perf_counter()
        poses, keep, order = self._decode_adaptive(stride, (cif, caf))
        self.last_decoder_time = time.perf_counter() - start
        return [self.annotations_from_tensor(poses[i], keep[i], order[i])
                for i in range(poses.shape[0])]

    def __call__(self, fields):
        return self.batch_decode([f[None] for f in fields])[0]

    def annotations_from_tensor(self, poses, keep, order):
        annotations = []
        for idx in order:
            if not keep[idx]:
                continue
            ann = Annotation(self.cif_meta.keypoints, self.caf_meta.skeleton,
                             score_weights=self.score_weights)
            pose = poses[idx]
            ann.data[:, 0] = pose[:, 1]
            ann.data[:, 1] = pose[:, 2]
            ann.data[:, 2] = pose[:, 0]
            ann.joint_scales = pose[:, 3].copy()
            annotations.append(ann)
        LOG.debug('annotations %d', len(annotations))
        return annotations


def cli(parser: argparse.ArgumentParser):
    CifCaf.cli(parser)


def configure(args: argparse.Namespace):
    CifCaf.configure(args)


def factory(head_metas) -> CifCaf:
    """The decoder for a model's head metas: one (Cif, Caf) pair."""
    decoders = CifCaf.factory(head_metas)
    if len(decoders) != 1:
        raise NotImplementedError(
            f'the port decodes exactly one (Cif, Caf) head pair, got '
            f'{[type(m).__name__ for m in head_metas]} (other decoders are '
            'ROADMAP A9/A10)')
    return decoders[0]
