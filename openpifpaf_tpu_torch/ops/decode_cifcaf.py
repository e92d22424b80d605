"""The CifCaf decode pipeline (port of ``openpifpaf_tpu/ops/decode_cifcaf.py``).

Stages: CifHr accumulation -> seed extraction -> CAF candidate rescoring
-> growth of all seeds at once -> seed-rank dedup -> budget certificate ->
keypoint NMS. The tensors keep the static budgets of the JAX package, so
the poses match it; a decode that exceeded a budget reports overflow and
the caller re-decodes through :meth:`CifCafDecoderConfig.crowd`.
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
    config. Fields of features that are not yet ported must keep their
    defaults (:meth:`check_ported` raises otherwise)."""
    cifhr_threshold: float = 0.3
    cifhr_neighbors: int = 16
    cifhr_min_scale: float = 0.0

    seed_threshold: float = 0.2
    seed_rescore: bool = True
    seed_ablation_nms: bool = False
    cifhr_skip: bool = False

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
    block_joints: bool = False
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
    n_caf_candidates: int = 256
    seed_nms: bool = True
    seed_rank_dedup: bool = True
    #: a TPU workaround (``lax.map`` over sub-batches); the port decodes
    #: image by image, so these change nothing
    batch_chunk: int = 8
    batch_chunk_threshold: int = 16
    seed_blob_compact: bool = False
    #: 'auto': the materialised CifHr map (the CUDA kernel on a CUDA
    #: tensor, its plain version on a CPU tensor)
    cifhr_impl: str = 'auto'
    #: only read by force-complete, which is not yet ported
    force_complete_dense: bool = False
    #: the CUDA kernel has no per-tile budget, so it is always exact
    cifhr_exact_tiles: bool = False
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

    #: features not yet ported: field -> (value it must keep, ROADMAP item)
    _NOT_PORTED = {
        'cifhr_impl': ('auto', "only the materialised map 'auto' is "
                       'ported; the lazy CifHr is ROADMAP A3'),
        'greedy': (False, 'greedy growth is ROADMAP A3'),
        'force_complete': (False, 'force-complete is ROADMAP A3'),
        'nms_before_force_complete': (False, 'force-complete is ROADMAP A3'),
        'block_joints': (False, 'block_joints is ROADMAP A3'),
        'export_decoding_order': (False, 'record_order is ROADMAP A3/A4'),
        'seed_ablation_nms': (False, 'seed ablations are ROADMAP A3'),
        'seed_blob_compact': (False, 'seed blob compaction is ROADMAP A3'),
        'seed_rescore': (True, 'rescore ablations are ROADMAP A3'),
        'caf_rescore': (True, 'rescore ablations are ROADMAP A3'),
        'cifhr_skip': (False, 'rescore ablations are ROADMAP A3'),
        'seed_nms': (True, 'decoding without seed NMS is ROADMAP A3'),
        'seed_rank_dedup': (True, 'decoding without seed-rank dedup is '
                            'ROADMAP A3'),
    }

    def check_ported(self):
        for name, (value, item) in self._NOT_PORTED.items():
            if getattr(self, name) != value:
                raise NotImplementedError(
                    f'CifCafDecoderConfig.{name}={getattr(self, name)!r} is '
                    f'not yet ported to PyTorch ({item})')
        if self.connection_method not in ('blend', 'max'):
            raise ValueError(
                f'unknown connection_method {self.connection_method!r}')


def decode_cifcaf_single(cif, caf, *, stride, skeleton, config,
                         graph: grow_mod.SkeletonGraph):
    """Decode one image. cif: (F, 5, H, W), caf: (E, 8, H, W) float32.

    Returns (poses (n_poses, n_kp, 4) [v, x, y, s] in hi-res pixels, keep,
    score-descending order, overflow): overflow is a bool scalar tensor,
    True when a static budget was exceeded and the caller should
    escalate to the crowd tier.
    """
    cfg = config
    _, _, h, w = cif.shape
    hr_shape = ((h - 1) * stride + 1, (w - 1) * stride + 1)
    occ = dict(reduction=cfg.occupancy_reduction,
               min_scale=cfg.occupancy_min_scale)

    hr, overflow = cifhr_mod.cif_hr(
        cif, stride, threshold=cfg.cifhr_threshold,
        min_scale=cfg.cifhr_min_scale, neighbors=cfg.cifhr_neighbors,
        n_cells=cfg.n_hr_cells, return_overflow=True)
    seeds, seed_cand = seeds_mod.cif_seeds(
        cif, hr, stride, threshold=cfg.seed_threshold, n_seeds=cfg.n_seeds,
        return_candidates=True)
    caf_cands, caf_overflow = caf_scored_mod.caf_scored(
        caf, hr, stride, skeleton, score_th=cfg.caf_score_th,
        cif_floor=cfg.caf_cif_floor, n_candidates=cfg.n_caf_candidates,
        return_overflow=True)
    overflow = overflow | caf_overflow

    seeds_all = seeds
    n_all = seeds_all['v'].shape[0]
    keep_idx, keep_valid = seeds_mod.seed_nms(
        seeds, graph.n_keypoints, hr_shape, n_keep=cfg.n_poses, **occ)
    lane_granted = torch.zeros((n_all,), dtype=torch.bool, device=cif.device)
    lane_granted[keep_idx] = keep_valid
    seeds = {k: v[keep_idx] for k, v in seeds.items()}
    seeds['v'] = torch.where(keep_valid, seeds['v'], 0.0)

    poses = grow_mod.grow_poses(
        caf_cands, graph, seeds,
        only_max=cfg.connection_method == 'max',
        keypoint_threshold=cfg.keypoint_threshold,
        keypoint_threshold_rel=cfg.keypoint_threshold_rel,
        reverse_match=cfg.reverse_match,
        filter_sigmas=cfg.filter_sigmas)
    accept = seeds_mod.seed_rank_dedup(
        poses, seeds['f'], seeds['x'], seeds['y'], seeds['v'] > 0.0,
        hr_shape, **occ)
    poses = torch.where(accept[:, None, None], poses, 0.0)

    # exactness certificate for the seed budgets: every truncated or
    # lane-less candidate must be covered by a grown pose's occupancy
    grown_occ = seeds_mod.occupancy_grid(poses, hr_shape, **occ)
    overflow = overflow | seeds_mod.uncovered_any(
        seed_cand['f'], seed_cand['x'], seed_cand['y'],
        seed_cand['dropped'], grown_occ, reduction=cfg.occupancy_reduction)
    overflow = overflow | seeds_mod.uncovered_any(
        seeds_all['f'], seeds_all['x'], seeds_all['y'],
        (seeds_all['v'] > 0.0) & ~lane_granted, grown_occ,
        reduction=cfg.occupancy_reduction)

    poses, keep, order = nms_mod.nms_keypoints(
        poses, hr_shape,
        suppression=cfg.nms_suppression,
        instance_threshold=cfg.nms_instance_threshold,
        keypoint_threshold=cfg.nms_keypoint_threshold,
        occupancy_reduction=cfg.occupancy_reduction,
        occupancy_min_scale=cfg.occupancy_min_scale)
    return poses, keep, order, overflow


def decode_cifcaf(cif, caf, *, stride, skeleton, config=None,
                  n_keypoints=None):
    """Batched decode, image by image. cif (B, F, 5, H, W), caf
    (B, E, 8, H, W) -> (poses (B, n_poses, n_kp, 4), keep (B, n_poses),
    order (B, n_poses), overflow (B,))."""
    config = config or CifCafDecoderConfig()
    config.check_ported()
    skeleton = np.asarray(skeleton, dtype=np.int64)
    if n_keypoints is None:
        n_keypoints = int(skeleton.max())
    graph = grow_mod.make_skeleton_graph(n_keypoints, skeleton)
    parts = [decode_cifcaf_single(c, a, stride=stride, skeleton=skeleton,
                                  config=config, graph=graph)
             for c, a in zip(cif, caf)]
    return tuple(torch.stack(p) for p in zip(*parts))
