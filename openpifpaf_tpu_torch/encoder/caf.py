"""CAF target painter (semantics of reference ``encoder/caf.py:16-311``).

Output (F, 9, H, W): [confidence, x1, y1, x2, y2, bmin1, bmin2, scale1,
scale2]. Work is split into three stages:

1. association selection — visibility, field-of-view, and dense-skeleton
   veto rules evaluated as (instances × skeleton-edges) boolean arrays;
2. candidate generation — for each selected association, the cells of the
   joint1→joint2 band (``num`` segment samples × ``s``² lateral offsets)
   are produced in one broadcast, deduplicated to their first occurrence;
3. global resolution — one perpendicular-distance nearest-writer sort
   across every association (``scatter.resolve`` with <= semantics), then
   a single scatter into the channel planes.
"""

import dataclasses
import logging
from typing import ClassVar, List, Optional, Tuple

import numpy as np

from .annrescaler import AnnRescaler
from .scatter import PaddedPlanes, resolve
from .. import headmeta

LOG = logging.getLogger(__name__)


@dataclasses.dataclass
class Caf:
    meta: headmeta.Caf
    rescaler: Optional[AnnRescaler] = None
    v_threshold: int = 0
    bmin: float = 0.1  #: in pixels
    visualizer: Optional[object] = None
    fill_plan: Optional[List[Tuple[int, int, int]]] = None

    min_size: ClassVar[int] = 3
    fixed_size: ClassVar[bool] = False
    aspect_ratio: ClassVar[float] = 0.0
    padding: ClassVar[int] = 10

    def __post_init__(self):
        if self.rescaler is None:
            self.rescaler = AnnRescaler(self.meta.stride, self.meta.pose)
        if self.fill_plan is None:
            self.fill_plan = [
                (caf_i, joint1i - 1, joint2i - 1)
                for caf_i, (joint1i, joint2i) in enumerate(self.meta.skeleton)
            ]

    def __call__(self, image, anns, meta):
        return paint_caf(self, self.rescaler, image.shape[1::-1], anns, meta)


def shortest_sparse_lengths(kps, sparse_skeleton_m1, v_threshold):
    """(I, K) length of the shortest *visible* sparse-skeleton connection
    incident to each joint (inf when none)."""
    e1, e2 = sparse_skeleton_m1[:, 0], sparse_skeleton_m1[:, 1]
    both_visible = ((kps[:, e1, 2] > v_threshold)
                    & (kps[:, e2, 2] > v_threshold))  # (I, Es)
    lengths = np.linalg.norm(kps[:, e1, :2] - kps[:, e2, :2], axis=-1)
    lengths = np.where(both_visible, lengths, np.inf)

    n_joints = kps.shape[1]
    incident = np.zeros((n_joints, len(e1)), dtype=bool)
    incident[e1, np.arange(len(e1))] = True
    incident[e2, np.arange(len(e2))] = True
    # min over incident edges, per instance and joint
    per_joint = np.where(incident[None], lengths[:, None, :], np.inf)
    return per_joint.min(axis=-1)


def select_associations(config: Caf, kps, grid_h, grid_w):
    """(I, P) mask of (instance, fill-plan entry) pairs to paint."""
    plan = np.asarray(config.fill_plan)
    j1, j2 = plan[:, 1], plan[:, 2]

    v1 = kps[:, j1, 2]
    v2 = kps[:, j2, 2]
    selected = (v1 > config.v_threshold) & (v2 > config.v_threshold)

    meta = config.meta
    if getattr(meta, 'sparse_skeleton', None) is not None:
        # dense edges yield to shorter sparse connections at both ends
        sparse_m1 = np.asarray(meta.sparse_skeleton) - 1
        shortest = shortest_sparse_lengths(kps, sparse_m1,
                                           config.v_threshold)
        edge_len = np.linalg.norm(kps[:, j1, :2] - kps[:, j2, :2], axis=-1)
        limit = edge_len / meta.dense_to_sparse_radius
        vetoed = ((shortest[:, j1] < limit) & (shortest[:, j2] < limit))
        selected &= ~vetoed

    out = ((kps[:, :, 0] < 0) | (kps[:, :, 1] < 0)
           | (kps[:, :, 0] > grid_w - 1) | (kps[:, :, 1] > grid_h - 1))
    out1, out2 = out[:, j1], out[:, j2]
    if meta.only_in_field_of_view:
        selected &= ~(out1 | out2)
    else:
        selected &= ~(out1 & out2)
    return selected


def band_cells(joint1, offset, offset_d, s, fixed_size, padding,
               grid_hp, grid_wp):
    """Deduplicated in-bounds cells of one association band.

    Returns integer cell coordinates fij (M, 2) on the padded grid, in
    first-occurrence generation order (segment-sample-major, lateral-
    offset-minor, matching the sequential fill order the <=-overwrite
    semantics depend on).
    """
    half = 0.5 * (s - 1)
    lateral = np.stack(np.meshgrid(np.linspace(-half, half, s),
                                   np.linspace(-half, half, s)),
                       axis=-1).reshape(-1, 2)  # (s², 2)

    if fixed_size:
        frange = np.array([0.5])
    else:
        fmargin = np.clip((s / 2) / (offset_d + np.spacing(1)), 0.25, 0.4)
        frange = np.linspace(fmargin, 1.0 - fmargin,
                             num=max(2, int(np.ceil(offset_d))))

    centers = (joint1[None, None, :]
               + frange[:, None, None] * offset[None, None, :]
               + lateral[None, :, :])  # (num, s², 2)
    fij = np.round(centers).astype(np.intc).reshape(-1, 2) + padding

    in_bounds = ((fij[:, 0] >= 0) & (fij[:, 0] < grid_wp)
                 & (fij[:, 1] >= 0) & (fij[:, 1] < grid_hp))
    fij = fij[in_bounds]
    if fij.size == 0:
        return fij
    flat = fij[:, 1].astype(np.int64) * grid_wp + fij[:, 0]
    _, first = np.unique(flat, return_index=True)
    return fij[np.sort(first)]


def paint_caf(config: Caf, rescaler, width_height, anns, meta):
    keypoint_sets = rescaler.keypoint_sets(anns)
    bg_mask = rescaler.bg_mask(
        anns, width_height, crowd_margin=(config.min_size - 1) / 2)
    valid_area = rescaler.valid_area(meta)

    n_fields = config.meta.n_fields
    planes = PaddedPlanes(n_fields, *bg_mask.shape, config.padding)

    conf = planes.plane(0.0)
    channels = {name: planes.plane(np.nan)
                for name in ('x1', 'y1', 'x2', 'y2',
                             'b1', 'b2', 's1', 's2')}
    planes.paint_region(conf, ~bg_mask, np.nan)
    barrier = planes.barrier_lookup(~bg_mask, 1.0)

    chunks = {'keys': [], 'metric': [], 'order': [],
              'x1': [], 'y1': [], 'x2': [], 'y2': [],
              'b1': [], 'b2': [], 's1': [], 's2': []}
    sigmas = config.meta.sigmas
    bmin = config.bmin / config.meta.stride
    grid_h, grid_w = bg_mask.shape

    if keypoint_sets:
        kps = np.stack(keypoint_sets)
        selected = select_associations(config, kps, grid_h, grid_w)
        plan = config.fill_plan
        instance_scales = [rescaler.scale(k) for k in keypoint_sets]

        for order, (inst, p) in enumerate(np.argwhere(selected)):
            field_i, j1i, j2i = plan[p]
            joint1 = kps[inst, j1i, :2]
            joint2 = kps[inst, j2i, :2]
            offset = joint2 - joint1
            offset_d = np.linalg.norm(offset)
            s = max(config.min_size,
                    int(offset_d * config.aspect_ratio))

            fij = band_cells(joint1, offset, offset_d, s,
                             config.fixed_size, config.padding,
                             planes.hp, planes.wp)
            if fij.size == 0:
                continue

            scale = instance_scales[inst]
            if sigmas is None:
                scale1 = scale2 = scale
            else:
                scale1 = scale * sigmas[j1i]
                scale2 = scale * sigmas[j2i]
            assert np.isnan(scale1) or 0.0 < scale1 < 100.0
            assert np.isnan(scale2) or 0.0 < scale2 < 100.0

            fxy = fij - config.padding
            along = fxy - joint1  # (M, 2), float64
            perp = (np.fabs(offset[1] * along[:, 0]
                            - offset[0] * along[:, 1])
                    / (offset_d + 0.01))

            m = fij.shape[0]
            chunks['keys'].append(
                planes.flat_keys(field_i, fij[:, 1], fij[:, 0]))
            chunks['metric'].append(perp)
            chunks['order'].append(np.full(m, order))
            chunks['x1'].append(joint1[0] - fxy[:, 0])
            chunks['y1'].append(joint1[1] - fxy[:, 1])
            chunks['x2'].append(joint2[0] - fxy[:, 0])
            chunks['y2'].append(joint2[1] - fxy[:, 1])
            chunks['b1'].append(np.full(m, bmin))
            chunks['b2'].append(np.full(m, bmin))
            chunks['s1'].append(np.full(m, scale1))
            chunks['s2'].append(np.full(m, scale2))

    if chunks['keys']:
        flat = {k: np.concatenate(v) for k, v in chunks.items()}
        won = resolve(flat['keys'], flat['metric'], flat['order'],
                      barrier[flat['keys']], ties='last')
        cells = flat['keys'][won]
        conf[cells] = 1.0
        for name, plane in channels.items():
            plane[cells] = flat[name][won]

    return np.stack(
        [planes.cropped(conf, valid_area, 0)]
        + [planes.cropped(channels[name], valid_area, np.nan)
           for name in ('x1', 'y1', 'x2', 'y2', 'b1', 'b2', 's1', 's2')],
        axis=1)
