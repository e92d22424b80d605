"""The CifCaf decode pipeline (port of ``openpifpaf_tpu/ops/decode_cifcaf.py``).

Stages: CifHr (the materialised map or the lazy cells) -> seed extraction
-> CAF candidate rescoring -> growth of initial poses and of all seeds at
once -> seed-rank dedup -> budget certificate -> optional force-complete
-> keypoint NMS. The tensors keep the static budgets of the JAX package,
so the poses match it; a decode that exceeded a budget reports overflow
and the caller re-decodes through :meth:`CifCafDecoderConfig.crowd`.
"""

import dataclasses

import numpy as np
import torch

from . import caf_scored as caf_scored_mod
from . import cifhr as cifhr_mod
from . import grow as grow_mod
from . import nms as nms_mod
from . import seeds as seeds_mod


@dataclasses.dataclass(frozen=True)
class CifCafDecoderConfig:
    """Decoder configuration: the fields and defaults of the JAX package's
    config (``openpifpaf_tpu/ops/decode_cifcaf.py``)."""
    cifhr_threshold: float = 0.3
    cifhr_neighbors: int = 16
    cifhr_min_scale: float = 0.0

    seed_threshold: float = 0.2
    seed_rescore: bool = True
    seed_ablation_nms: bool = False  # --ablation-cifseeds-nms
    cifhr_skip: bool = False  # both no-rescore ablations active

    caf_score_th: float = 0.3
    caf_cif_floor: float = 0.1
    caf_rescore: bool = True

    keypoint_threshold: float = 0.15
    keypoint_threshold_rel: float = 0.5
    reverse_match: bool = True
    filter_sigmas: float = 1.0
    #: 'blend' (top-2 within-sigma blend) or 'max'
    connection_method: str = 'blend'
    greedy: bool = False
    block_joints: bool = False  # --cifcaf-block-joints
    force_complete: bool = False
    force_complete_caf_th: float = 0.001
    nms_before_force_complete: bool = False

    nms_suppression: float = 1e-5
    nms_instance_threshold: float = 0.15
    nms_keypoint_threshold: float = 0.15
    occupancy_reduction: float = 2.0
    occupancy_min_scale: float = 4.0

    # static work budgets; exceeding one raises the overflow flag
    n_hr_cells: int = 256
    n_seeds: int = 256
    n_poses: int = 96
    #: top-K compaction of each CAF plane (0: the full dense planes)
    n_caf_candidates: int = 256
    #: seed NMS before growth; without it the first ``n_poses`` seeds grow
    seed_nms: bool = True
    #: accept lanes like the reference's sequential seed gate
    seed_rank_dedup: bool = True
    #: a TPU workaround (``lax.map`` over sub-batches); the port decodes
    #: image by image, so these change nothing
    batch_chunk: int = 8
    batch_chunk_threshold: int = 16
    #: keep one 3x3 peak per confidence blob before the seed budget (exact
    #: only for encoder-consistent fields)
    seed_blob_compact: bool = False
    #: 'auto' (the map: the CUDA kernel on a CUDA tensor, the plain
    #: version on a CPU tensor; JAX's 'auto' means 'lazy'), 'pallas' (the
    #: CUDA kernel's map; a CUDA tensor only), 'dense' (the plain map) or
    #: 'lazy' (the splat cells evaluated at the query points)
    cifhr_impl: str = 'auto'
    #: no candidate compaction in the force-complete pass (the crowd tier)
    force_complete_dense: bool = False
    #: the CUDA kernel has no per-tile budget, so it is always exact
    cifhr_exact_tiles: bool = False
    #: also output per-joint (commit_edge, commit_step), the reference's
    #: per-annotation decoding order (``cifcaf.cpp:309-346``)
    export_decoding_order: bool = False

    def crowd(self, scale: int = 16) -> 'CifCafDecoderConfig':
        """The crowd-tier variant: budgets scaled to cover 40+ people."""
        return dataclasses.replace(
            self,
            n_hr_cells=max(self.n_hr_cells, 64 * scale),
            n_seeds=max(self.n_seeds, 256 * scale),
            n_caf_candidates=max(self.n_caf_candidates, 64 * scale)
            if self.n_caf_candidates else 0,
            n_poses=max(self.n_poses, 48 * scale),
            force_complete_dense=True,
            cifhr_exact_tiles=True)

    def check(self):
        """Raise ``ValueError`` for a value that no code path takes."""
        if self.connection_method not in ('blend', 'max'):
            raise ValueError(
                f'unknown connection_method {self.connection_method!r}')
        impls = cifhr_mod.MAP_IMPLS + ('lazy',)
        if self.cifhr_impl not in impls:
            raise ValueError(f'unknown cifhr_impl {self.cifhr_impl!r}, '
                             f'want one of {impls}')


def _cifhr(cif, stride, cfg, hr_shape):
    """(hr map or None, lazy cells or None, overflow) of ``cfg.cifhr_impl``;
    zeros under ``cifhr_skip`` (the reference skips CifHr when both rescore
    ablations are on)."""
    if cfg.cifhr_skip:
        overflow = torch.zeros((), dtype=torch.bool, device=cif.device)
        if cfg.cifhr_impl == 'lazy':
            z = torch.zeros((cif.shape[0], 1), dtype=torch.float32,
                            device=cif.device)
            return None, {'x': z, 'y': z, 'sigma': z, 'w': z}, overflow
        return torch.zeros((cif.shape[0],) + hr_shape, dtype=torch.float32,
                           device=cif.device), None, overflow
    kw = dict(threshold=cfg.cifhr_threshold, min_scale=cfg.cifhr_min_scale,
              neighbors=cfg.cifhr_neighbors, n_cells=cfg.n_hr_cells)
    if cfg.cifhr_impl == 'lazy':
        cells, _, _, overflow = cifhr_mod.cif_hr_cells(cif, stride, **kw)
        return None, cells, overflow
    hr, overflow = cifhr_mod.cif_hr(cif, stride, impl=cfg.cifhr_impl,
                                    return_overflow=True, **kw)
    return hr, None, overflow


def decode_cifcaf_single(cif, caf, initial_poses=None, *, stride, skeleton,
                         config, graph: grow_mod.SkeletonGraph):
    """Decode one image. cif: (F, 5, H, W), caf: (E, 8, H, W) float32.

    initial_poses: optional (K_init, n_kp, 4) partial poses (e.g. tracked
    annotations of the previous frame). They grow first, their joints
    suppress the seeds whose cell they occupy, and the outputs keep them
    in slots [0, K_init).

    Returns (poses (K_init + n_poses, n_kp, 4) [v, x, y, s] in hi-res
    pixels, keep, score-descending order[, commit_edge, commit_step],
    overflow): the commit arrays (K, n_kp) come with
    ``export_decoding_order``; overflow is a bool scalar tensor, True when
    a static budget was exceeded and the caller should escalate to the
    crowd tier.
    """
    cfg = config
    _, _, h, w = cif.shape
    hr_shape = ((h - 1) * stride + 1, (w - 1) * stride + 1)
    occ = dict(reduction=cfg.occupancy_reduction,
               min_scale=cfg.occupancy_min_scale)
    nms_kw = dict(suppression=cfg.nms_suppression,
                  instance_threshold=cfg.nms_instance_threshold,
                  keypoint_threshold=cfg.nms_keypoint_threshold,
                  occupancy_reduction=cfg.occupancy_reduction,
                  occupancy_min_scale=cfg.occupancy_min_scale)

    hr, hr_cells, overflow = _cifhr(cif, stride, cfg, hr_shape)
    lazy = dict(hr_cells=hr_cells, hr_shape=hr_shape)
    seeds, seed_cand = seeds_mod.cif_seeds(
        cif, hr, stride, threshold=cfg.seed_threshold, n_seeds=cfg.n_seeds,
        rescore=cfg.seed_rescore, nms=cfg.seed_ablation_nms,
        blob_compact=cfg.seed_blob_compact, return_candidates=True, **lazy)
    caf_kw = dict(cif_floor=cfg.caf_cif_floor, rescore=cfg.caf_rescore,
                  return_overflow=True, **lazy)
    caf_cands, caf_overflow = caf_scored_mod.caf_scored(
        caf, hr, stride, skeleton, score_th=cfg.caf_score_th,
        n_candidates=cfg.n_caf_candidates, **caf_kw)
    overflow = overflow | caf_overflow

    record = cfg.export_decoding_order
    grow_kw = dict(only_max=cfg.connection_method == 'max',
                   keypoint_threshold=cfg.keypoint_threshold,
                   keypoint_threshold_rel=cfg.keypoint_threshold_rel,
                   reverse_match=cfg.reverse_match,
                   filter_sigmas=cfg.filter_sigmas, greedy=cfg.greedy,
                   block_joints=cfg.block_joints, record_order=record)

    def grown(out):
        """(poses, commit_edge or None, commit_step or None)."""
        return out if record else (out, None, None)

    n_init = 0
    seed_occ0 = None
    if initial_poses is not None:
        n_init = initial_poses.shape[0]
        initial = grown(grow_mod.grow_from_poses(caf_cands, graph,
                                                 initial_poses, **grow_kw))
        # nms.mark_occupancy of the JAX package: the same window semantics
        seed_occ0 = seeds_mod.occupancy_grid(initial[0], hr_shape, **occ)

    seeds_all = seeds
    n_all = seeds_all['v'].shape[0]
    if cfg.seed_nms:
        keep_idx, keep_valid = seeds_mod.seed_nms(
            seeds, graph.n_keypoints, hr_shape, n_keep=cfg.n_poses,
            occ0=seed_occ0, **occ)
        lane_granted = torch.zeros((n_all,), dtype=torch.bool,
                                   device=cif.device)
        lane_granted[keep_idx] = keep_valid
        seeds = {k: v[keep_idx] for k, v in seeds.items()}
        seeds['v'] = torch.where(keep_valid, seeds['v'], 0.0)
    else:
        lane_granted = torch.arange(n_all, device=cif.device) < cfg.n_poses
        seeds = {k: v[:cfg.n_poses] for k, v in seeds.items()}

    poses, commit_edge, commit_step = grown(
        grow_mod.grow_poses(caf_cands, graph, seeds, **grow_kw))
    if initial_poses is not None:
        poses, commit_edge, commit_step = (
            None if a is None else torch.cat([i, a])
            for i, a in zip(initial, (poses, commit_edge, commit_step)))

    if cfg.seed_rank_dedup:
        accept = seeds_mod.seed_rank_dedup(
            poses, seeds['f'], seeds['x'], seeds['y'], seeds['v'] > 0.0,
            hr_shape, n_initial=n_init, **occ)
        poses = torch.where(accept[:, None, None], poses, 0.0)
        if record:
            commit_edge = torch.where(accept[:, None], commit_edge, -1)
            commit_step = torch.where(accept[:, None], commit_step, -1)

    # exactness certificate for the seed budgets: every truncated or
    # lane-less candidate must be covered by a grown pose's occupancy
    # (taken before force-complete and NMS)
    grown_occ = seeds_mod.occupancy_grid(poses, hr_shape, **occ)
    overflow = overflow | seeds_mod.uncovered_any(
        seed_cand['f'], seed_cand['x'], seed_cand['y'],
        seed_cand['dropped'], grown_occ, reduction=cfg.occupancy_reduction)
    overflow = overflow | seeds_mod.uncovered_any(
        seeds_all['f'], seeds_all['x'], seeds_all['y'],
        (seeds_all['v'] > 0.0) & ~lane_granted, grown_occ,
        reduction=cfg.occupancy_reduction)

    if cfg.force_complete:
        if cfg.nms_before_force_complete:
            poses, pre_keep, _ = nms_mod.nms_keypoints(poses, hr_shape,
                                                       **nms_kw)
            poses = torch.where(pre_keep[:, None, None], poses, 0.0)
        # a second grow on low-threshold candidates, no reverse match, a
        # wide filter window (cifcaf.cpp:414-426), then the flood fill; the
        # completion pass gets 4x the candidate budget (the crowd tier the
        # full planes), and a truncation there raises the overflow flag
        fc_budget = 0 if cfg.force_complete_dense \
            else 4 * cfg.n_caf_candidates
        caf_low, caf_low_overflow = caf_scored_mod.caf_scored(
            caf, hr, stride, skeleton, score_th=cfg.force_complete_caf_th,
            n_candidates=fc_budget, **caf_kw)
        overflow = overflow | caf_low_overflow
        poses, fc_edge, fc_step = grown(grow_mod.grow_from_poses(
            caf_low, graph, poses,
            keypoint_threshold=cfg.keypoint_threshold,
            keypoint_threshold_rel=cfg.keypoint_threshold_rel,
            reverse_match=False, filter_sigmas=4.0, greedy=cfg.greedy,
            record_order=record))
        if record:
            # the completion's commits continue the decoding order after
            # the main pass's bound of steps (n_kp + 2E when greedy)
            offset = graph.n_keypoints \
                + (2 * len(skeleton) if cfg.greedy else 0)
            fresh = (commit_edge < 0) & (fc_edge >= 0)
            commit_edge = torch.where(fresh, fc_edge, commit_edge)
            commit_step = torch.where(fresh, fc_step + offset, commit_step)
        poses = grow_mod.flood_fill_poses(graph, poses)

    poses, keep, order = nms_mod.nms_keypoints(poses, hr_shape, **nms_kw)
    if record:
        return poses, keep, order, commit_edge, commit_step, overflow
    return poses, keep, order, overflow


def decode_cifcaf(cif, caf, initial_poses=None, *, stride, skeleton,
                  config=None, n_keypoints=None):
    """Batched decode, image by image. cif (B, F, 5, H, W), caf
    (B, E, 8, H, W), initial_poses optional (B, K_init, n_kp, 4) ->
    (poses (B, K, n_kp, 4), keep (B, K), order (B, K)[, commit_edge
    (B, K, n_kp), commit_step (B, K, n_kp)], overflow (B,)), the commit
    arrays with ``config.export_decoding_order``."""
    config = config or CifCafDecoderConfig()
    config.check()
    skeleton = np.asarray(skeleton, dtype=np.int64)
    if n_keypoints is None:
        n_keypoints = int(skeleton.max())
    graph = grow_mod.make_skeleton_graph(n_keypoints, skeleton)
    if initial_poses is None:
        initial_poses = [None] * cif.shape[0]
    parts = [decode_cifcaf_single(c, a, p, stride=stride, skeleton=skeleton,
                                  config=config, graph=graph)
             for c, a, p in zip(cif, caf, initial_poses)]
    return tuple(torch.stack(p) for p in zip(*parts))


def build_cifcaf_decoder(*, stride: int, skeleton, config=None,
                         n_keypoints=None):
    """The batched CifCaf decode as one function of tensors, with no host
    read on its path, so that ``torch.export`` can trace it (the
    counterpart of ``openpifpaf_tpu/ops/decode_cifcaf.py::
    build_cifcaf_decoder``).

    Returns fn(cif, caf) with cif (B, F, 5, H, W), caf (B, E, 8, H, W) ->
    (poses (B, n_poses, n_kp, 4), keep (B, n_poses), order (B, n_poses)):
    :func:`decode_cifcaf` without its overflow output. With
    ``config.export_decoding_order`` two extra outputs (B, n_poses, n_kp)
    report each joint's committing directed edge and commit step. It
    never escalates to the crowd tier, as JAX's export builds it
    (``with_overflow=False``).
    """
    def decode(cif, caf):
        return decode_cifcaf(cif, caf, stride=stride, skeleton=skeleton,
                             config=config, n_keypoints=n_keypoints)[:-1]

    return decode
