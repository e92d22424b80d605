"""CifCaf decoders (port of ``openpifpaf_tpu/decoder/cifcaf.py``):
CLI-configurable thresholds, ablations and budgets, the adaptive two-tier
decode, initial (tracked) poses, the decoding order, the tensor ->
Annotation conversion, and ``CifCafDense`` over sparse + dense CAF heads.
The decoders' registry and the global ``--cif-th``/``--caf-th`` are
:mod:`.factory`'s.

On the card the decode runs on a side CUDA stream of its device (the
fields' device, or ``cuda:k`` with ``decode_device = k``), which waits
for the forward that made the fields. ``batch_decode_deferred`` splits a
decode in two: the dispatch only queues that wait (and the copy to
``cuda:k``); ``materialize()`` runs the decode, whose host syncs (the
fixpoints' flags, the growth's gather, the crowd tier's overflow read)
then wait for the side stream alone, so a forward queued on the main
stream in between runs under the decode. The dispatch queues no decode
work on the side stream: a batch's decode queued there before the
previous batch's materialize would make that decode wait for this
batch's forward.
"""

import argparse
import contextlib
import dataclasses
import logging
import time
from typing import List

import numpy as np
import torch

from .. import headmeta
from ..annotation import Annotation
from ..ops.decode_cifcaf import CifCafDecoderConfig, decode_cifcaf
from ..visualizer.base import Base as VisualizerBase
from .base import Decoder

LOG = logging.getLogger(__name__)

#: the decode's side stream of each CUDA device, made at first use
_SIDE_STREAMS = {}


def side_stream(device):
    """The side CUDA stream on which the decodes of ``device`` run."""
    device = torch.device(device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _SIDE_STREAMS:
        _SIDE_STREAMS[index] = torch.cuda.Stream(device=index)
    return _SIDE_STREAMS[index]


class CifCaf(Decoder):
    # CLI-configurable statics (the JAX decoder's flags)
    force_complete = False
    keypoint_threshold = 0.15
    keypoint_threshold_rel = 0.5
    greedy = False
    reverse_match = True
    nms_before_force_complete = False
    instance_threshold = 0.15
    seed_threshold = 0.2
    keypoint_threshold_nms = 0.15
    force_complete_caf_th = 0.001
    cifhr_threshold = 0.3
    caf_score_th = 0.3
    connection_method = 'blend'
    block_joints = False
    seed_rescore = True
    seed_ablation_nms = False
    caf_rescore = True
    ablation_independent_kp = False
    n_seeds = 256
    n_poses = 96
    #: pose budget of the crowd tier (None: the auto-scaled budget)
    n_poses_crowd = None
    n_hr_cells = 256
    #: record each joint's committing edge and step and fill
    #: Annotation.decoding_order / frontier_order (set by the callers that
    #: draw them, as the JAX package's show CLI does)
    export_decoding_order = False
    #: ``--decode-device k``: decode on ``cuda:k``, the fields copied
    #: there; out of range (or on the CPU) the decode stays on the fields'
    #: device, with one warning per process
    decode_device = None
    _warned_decode_device = False

    def __init__(self, cif_meta: headmeta.Cif, caf_meta: headmeta.Caf):
        super().__init__()
        self.cif_meta = cif_meta
        self.caf_meta = caf_meta
        self.skeleton = np.asarray(caf_meta.skeleton, dtype=np.int64)
        self.n_keypoints = len(cif_meta.keypoints)
        self.score_weights = cif_meta.score_weights
        #: indices of the images of the last batch re-decoded at the
        #: crowd tier
        self.last_escalated = []

        self.config = CifCafDecoderConfig(
            cifhr_threshold=self.cifhr_threshold,
            cifhr_skip=not self.seed_rescore and not self.caf_rescore,
            seed_threshold=self.seed_threshold,
            seed_rescore=self.seed_rescore,
            seed_ablation_nms=self.seed_ablation_nms,
            caf_score_th=self.caf_score_th,
            caf_rescore=self.caf_rescore,
            keypoint_threshold=self.keypoint_threshold,
            keypoint_threshold_rel=self.keypoint_threshold_rel,
            reverse_match=self.reverse_match,
            connection_method=self.connection_method,
            greedy=self.greedy,
            block_joints=self.block_joints,
            force_complete=self.force_complete,
            force_complete_caf_th=self.force_complete_caf_th,
            nms_before_force_complete=self.nms_before_force_complete,
            nms_instance_threshold=self.instance_threshold,
            nms_keypoint_threshold=self.keypoint_threshold_nms,
            n_seeds=self.n_seeds,
            n_poses=self.n_poses,
            n_hr_cells=self.n_hr_cells,
            export_decoding_order=self.export_decoding_order,
        )

    @classmethod
    def cli(cls, parser: argparse.ArgumentParser):
        group = parser.add_argument_group('CifCaf decoder')
        group.add_argument('--force-complete-pose', dest='force_complete',
                           default=cls.force_complete, action='store_true')
        group.add_argument('--force-complete-caf-th', type=float,
                           default=cls.force_complete_caf_th,
                           help='CAF threshold for force complete. '
                                'Set to -1 to deactivate.')
        group.add_argument('--nms-before-force-complete',
                           default=False, action='store_true',
                           help='run an additional NMS before '
                                'completing poses')
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
        group.add_argument('--greedy', default=cls.greedy,
                           action='store_true')
        group.add_argument('--connection-method',
                           default=cls.connection_method,
                           choices=('blend', 'max'),
                           help='connection blending (cifcaf.cpp:32-113)')
        group.add_argument('--cifcaf-block-joints', default=False,
                           action='store_true', help='block joints')
        group.add_argument('--no-reverse-match', dest='reverse_match',
                           default=True, action='store_false')
        group.add_argument('--ablation-cifseeds-nms',
                           default=False, action='store_true')
        group.add_argument('--ablation-cifseeds-no-rescore',
                           default=False, action='store_true')
        group.add_argument('--ablation-caf-no-rescore',
                           default=False, action='store_true')
        group.add_argument('--ablation-independent-kp',
                           default=False, action='store_true')
        group.add_argument('--decoder-seeds', type=int, default=cls.n_seeds,
                           help='static seed budget of the decoder')
        group.add_argument('--decoder-poses', type=int, default=cls.n_poses,
                           help='static pose budget of the decoder')
        group.add_argument('--decoder-crowd-poses', type=int,
                           default=cls.n_poses_crowd,
                           help='pose budget of the crowd escalation tier')

    @classmethod
    def configure(cls, args: argparse.Namespace):
        cls.force_complete = args.force_complete
        cls.force_complete_caf_th = args.force_complete_caf_th
        cls.nms_before_force_complete = args.nms_before_force_complete
        cls.keypoint_threshold = args.keypoint_threshold
        cls.keypoint_threshold_rel = args.keypoint_threshold_rel
        # force-complete zeroes the growth thresholds and the NMS keypoint
        # threshold; --ablation-independent-kp keeps the growth keypoint
        # threshold
        cls.keypoint_threshold_nms = args.keypoint_threshold
        if args.force_complete:
            if not args.ablation_independent_kp:
                cls.keypoint_threshold = 0.0
            cls.keypoint_threshold_rel = 0.0
            cls.keypoint_threshold_nms = 0.0
        if args.seed_threshold < cls.keypoint_threshold:
            cls.keypoint_threshold = args.seed_threshold
        cls.instance_threshold = args.instance_threshold
        cls.seed_threshold = args.seed_threshold
        cls.greedy = args.greedy
        cls.connection_method = args.connection_method
        cls.block_joints = args.cifcaf_block_joints
        cls.reverse_match = args.reverse_match
        cls.seed_ablation_nms = args.ablation_cifseeds_nms
        cls.seed_rescore = not args.ablation_cifseeds_no_rescore
        cls.caf_rescore = not args.ablation_caf_no_rescore
        cls.ablation_independent_kp = args.ablation_independent_kp
        cls.n_seeds = args.decoder_seeds
        cls.n_poses = args.decoder_poses
        cls.n_poses_crowd = args.decoder_crowd_poses

    @classmethod
    def factory(cls, head_metas) -> List['CifCaf']:
        """Pair adjacent (Cif, Caf) metas; none when ``--dense-connections``
        asks for :class:`CifCafDense`."""
        if CifCafDense.dense_coupling:
            return []
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

    def _decode(self, stride, cif, caf, initial_poses=None, crowd=False):
        return decode_cifcaf(
            cif, caf, initial_poses, stride=stride, skeleton=self.skeleton,
            config=self._crowd_config() if crowd else self.config,
            n_keypoints=self.n_keypoints)

    def _decode_adaptive(self, stride, args):
        """Fast-tier decode of the batch (``args``: cif, caf[, initial
        poses]), then crowd-tier re-decode of the images that exceeded a
        budget. Returns numpy (poses, keep, order[, commit_edge,
        commit_step])."""
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

    def _initial_poses(self, initial_annotations_batch, batch, device):
        """(B, K_init, n_kp, 4) initial poses, K_init the largest count
        rounded up to a multiple of 8 (at least 8), and (B, K_init) ids
        (-1: none)."""
        n_init = max((len(anns) for anns in initial_annotations_batch),
                     default=0)
        k_init = max(8, int(np.ceil(n_init / 8)) * 8)
        poses = np.zeros((batch, k_init, self.n_keypoints, 4),
                         dtype=np.float32)
        ids = np.full((batch, k_init), -1, dtype=np.int64)
        for b, anns in enumerate(initial_annotations_batch):
            for i, ann in enumerate(anns[:k_init]):
                poses[b, i, :, 0] = ann.data[:, 2]
                poses[b, i, :, 1] = ann.data[:, 0]
                poses[b, i, :, 2] = ann.data[:, 1]
                poses[b, i, :, 3] = ann.joint_scales
                ids[b, i] = getattr(ann, 'id_', -1) or -1
        return torch.from_numpy(poses).to(device), ids

    def _decode_target(self, device):
        """The device of the decode: ``cuda:decode_device`` when that
        exists, else ``device`` (the fields' own), warning once."""
        if self.decode_device is None:
            return device
        count = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if 0 <= self.decode_device < count:
            return torch.device('cuda', self.decode_device)
        if not CifCaf._warned_decode_device:
            CifCaf._warned_decode_device = True
            LOG.warning('decode_device=%d but only %d CUDA devices; '
                        'decoding on the fields\' device %s',
                        self.decode_device, count, device)
        return device

    def batch_decode(self, fields_batch, initial_annotations_batch=None):
        """fields_batch: list over head indices of (B, F, C, H, W) tensors;
        initial_annotations_batch: optional list over images of annotations
        (e.g. tracked from the previous frame) that grow first and keep
        their ``id_``. Returns one list of annotations per image."""
        return self.batch_decode_deferred(fields_batch,
                                          initial_annotations_batch)()

    def batch_decode_deferred(self, fields_batch,
                              initial_annotations_batch=None):
        """Queue the decode of ``fields_batch``; return ``materialize()``,
        which runs it and returns the annotations of each image (see the
        module's docstring for the streams). ``last_decoder_time`` counts
        the dispatch and the materialize."""
        cif = fields_batch[self.cif_meta.head_index]
        caf = fields_batch[self.caf_meta.head_index]
        cif, caf = (torch.as_tensor(f, dtype=torch.float32)
                    for f in (cif, caf))
        stride = self.cif_meta.stride
        assert stride == self.caf_meta.stride

        if VisualizerBase.all_indices:
            # --debug-indices: batch element 0, the image the visualizer
            # base keeps as the backdrop, drawn on the host
            from .. import visualizer
            visualizer.Cif(self.cif_meta).predicted(cif[0].cpu().numpy())
            visualizer.Caf(self.caf_meta).predicted(caf[0].cpu().numpy())

        start = time.perf_counter()
        target = self._decode_target(cif.device)
        stream = None
        # the fields as made: another device's are read by the copy on the
        # side stream, whose work has ended when materialize() returns
        # (the decode ends in copies to the host)
        sources = (cif, caf)
        if target.type == 'cuda':
            stream = side_stream(target)
            if cif.device.type == 'cuda':
                # the forward that made the fields, queued on the current
                # stream of their device
                stream.wait_stream(torch.cuda.current_stream(cif.device))
            if cif.device == target:
                for field in sources:
                    # read on the side stream: not reused before it ran
                    field.record_stream(stream)
            with torch.cuda.stream(stream):
                cif, caf = (f.to(target, non_blocking=True)
                            for f in sources)
        dispatch_time = time.perf_counter() - start

        def materialize(_sources=sources):
            t0 = time.perf_counter()
            context = torch.cuda.stream(stream) if stream is not None \
                else contextlib.nullcontext()
            with context:
                args = (cif, caf)
                ids_batch = None
                if initial_annotations_batch is not None:
                    initial_poses, ids_batch = self._initial_poses(
                        initial_annotations_batch, cif.shape[0], target)
                    args += (initial_poses,)
                poses, keep, order, *commit = self._decode_adaptive(
                    stride, args)
            self.last_decoder_time = dispatch_time \
                + (time.perf_counter() - t0)
            return [
                self.annotations_from_tensor(
                    poses[i], keep[i], order[i],
                    ids=None if ids_batch is None else ids_batch[i],
                    commit_edge=commit[0][i] if commit else None,
                    commit_step=commit[1][i] if commit else None)
                for i in range(poses.shape[0])
            ]

        return materialize

    def __call__(self, fields, initial_annotations=None):
        initial = [initial_annotations] if initial_annotations else None
        return self.batch_decode([f[None] for f in fields], initial)[0]

    def annotations_from_tensor(self, poses, keep, order, ids=None,
                                commit_edge=None, commit_step=None):
        n_edges = len(self.skeleton)
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
            if ids is not None and idx < len(ids) and ids[idx] != -1:
                ann.id_ = int(ids[idx])
            if commit_edge is not None:
                self._fill_decoding_order(ann, commit_edge[idx],
                                          commit_step[idx], n_edges)
            annotations.append(ann)
        LOG.debug('annotations %d', len(annotations))
        return annotations

    def _fill_decoding_order(self, ann, commit_edge, commit_step, n_edges):
        """decoding_order entries (jsi, jti, jsxyv, jtxyv) in commit order,
        and frontier_order: the directed edges whose target was never
        connected. Joint coordinates come from the final pose (a committed
        joint never changes)."""
        committed = [(int(s), int(e)) for e, s in
                     zip(commit_edge, commit_step) if e >= 0]
        for _, edge in sorted(committed):
            if edge < n_edges:
                jsi, jti = (int(self.skeleton[edge][0]) - 1,
                            int(self.skeleton[edge][1]) - 1)
            else:
                jti, jsi = (int(self.skeleton[edge - n_edges][0]) - 1,
                            int(self.skeleton[edge - n_edges][1]) - 1)
            ann.decoding_order.append(
                (jsi, jti, ann.data[jsi].copy(), ann.data[jti].copy()))
        connected = {jti for _, jti, _, __ in ann.decoding_order}
        v = ann.data[:, 2]
        # --cifcaf-block-joints marks unreachable targets with v = 1e-5 at
        # the origin: they are no frontier
        blocked = (v > 0.0) & (ann.data[:, 0] == 0.0) \
            & (ann.data[:, 1] == 0.0)
        for jsi, jti in (self.skeleton - 1):
            for s, t in ((int(jsi), int(jti)), (int(jti), int(jsi))):
                if v[s] > 0 and v[t] <= 1e-5 and t not in connected \
                        and not blocked[t]:
                    ann.frontier_order.append((s, t))


class CifCafDense(Decoder):
    """Decode with the sparse and the dense CAF fields concatenated along
    the edge axis (``--dense-connections``)."""

    dense_coupling = 0.0

    def __init__(self, cif_meta: headmeta.Cif, caf_meta: headmeta.Caf,
                 dense_caf_meta: headmeta.Caf):
        super().__init__()
        self.cif_meta = cif_meta
        self.caf_meta = caf_meta
        self.dense_caf_meta = dense_caf_meta

        self.dense_caf_meta.decoder_confidence_scales = [
            self.dense_coupling for _ in self.dense_caf_meta.skeleton]
        concatenated = headmeta.Caf.concatenate([caf_meta, dense_caf_meta])
        self.cifcaf = CifCaf(cif_meta, concatenated)

    @property
    def last_escalated(self):
        return self.cifcaf.last_escalated

    @classmethod
    def cli(cls, parser: argparse.ArgumentParser):
        group = parser.add_argument_group('CifCafDense decoder')
        group.add_argument('--dense-connections', nargs='?', type=float,
                           default=0.0, const=1.0)

    @classmethod
    def configure(cls, args: argparse.Namespace):
        cls.dense_coupling = args.dense_connections

    @classmethod
    def factory(cls, head_metas) -> List['CifCafDense']:
        """(Cif, Caf, dense Caf) triples; none without a dense coupling."""
        if len(head_metas) < 3 or not cls.dense_coupling:
            return []
        return [
            cls(cif_meta, caf_meta, dense_meta)
            for cif_meta, caf_meta, dense_meta
            in zip(head_metas, head_metas[1:], head_metas[2:])
            if (isinstance(cif_meta, headmeta.Cif)
                and isinstance(caf_meta, headmeta.Caf)
                and isinstance(dense_meta, headmeta.Caf))
        ]

    def batch_decode(self, fields_batch, initial_annotations_batch=None):
        merged = list(fields_batch)
        # the concatenated meta reads the sparse head's index
        merged[self.caf_meta.head_index] = torch.cat([
            torch.as_tensor(fields_batch[self.caf_meta.head_index]),
            torch.as_tensor(fields_batch[self.dense_caf_meta.head_index]),
        ], dim=1)
        out = self.cifcaf.batch_decode(merged, initial_annotations_batch)
        self.last_decoder_time = self.cifcaf.last_decoder_time
        return out

    def __call__(self, fields, initial_annotations=None):
        initial = [initial_annotations] if initial_annotations else None
        return self.batch_decode([f[None] for f in fields], initial)[0]

