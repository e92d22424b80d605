"""CIF target painter (semantics of reference ``encoder/cif.py:16-151``).

Output (F, 5, H, W): [confidence, x-offset, y-offset, bmin, joint scale].
Every visible joint contributes a ``side_length``² patch of candidate cell
writes; all candidates across all instances are generated as one batch and
resolved with a single nearest-writer sort (see ``scatter.resolve``) —
no per-keypoint Python loop, no mutable stamping state.
"""

import dataclasses
import logging
from typing import ClassVar, Optional

import numpy as np

from .annrescaler import AnnRescaler
from .scatter import PaddedPlanes, resolve
from .. import headmeta
from ..utils import create_sink

LOG = logging.getLogger(__name__)


@dataclasses.dataclass
class Cif:
    meta: headmeta.Cif
    rescaler: Optional[AnnRescaler] = None
    v_threshold: int = 0
    bmin: float = 0.1  #: in pixels
    visualizer: Optional[object] = None

    side_length: ClassVar[int] = 4
    padding: ClassVar[int] = 10

    def __call__(self, image, anns, meta):
        rescaler = self.rescaler or AnnRescaler(self.meta.stride,
                                                self.meta.pose)
        return paint_cif(self, rescaler, image.shape[1::-1], anns, meta)


def joint_scales(rescaler, keypoint_sets, sigmas):
    """(I, K) per-joint scale targets: instance scale times the joint's
    sigma (or the raw instance scale when the meta has no sigmas)."""
    instance_scales = [rescaler.scale(kps) for kps in keypoint_sets]
    if sigmas is None:
        rows = [[s] * keypoint_sets[0].shape[0] for s in instance_scales]
    else:
        rows = [[s * sigma for sigma in sigmas] for s in instance_scales]
    return np.asarray(rows, dtype=np.float32)


def patch_candidates(xy, side_length, padding):
    """Candidate cell writes for sub-pixel locations ``xy`` (N, 2).

    Returns (ys, xs) integer cell coordinates (N, S, S) on the padded
    grid, the regression payload sink_reg (N, 2, S, S), its norm
    sink_l (N, S, S), and an in-bounds validity prerequisite mask (N,)
    computed by the caller from ys/xs extents.
    """
    s_offset = (side_length - 1.0) / 2.0
    corner = np.round(xy - s_offset).astype(np.intc) + padding  # (N, 2)
    # exact offset from patch grid to the true sub-pixel location
    offset = xy - (corner + s_offset - padding)  # float64 (N, 2)

    sink = create_sink(side_length)  # (2, S, S)
    sink_reg = sink[None] + offset[:, :, None, None]  # (N, 2, S, S)
    sink_l = np.sqrt(sink_reg[:, 0] ** 2 + sink_reg[:, 1] ** 2)

    span = np.arange(side_length)
    ys = corner[:, 1, None, None] + span[None, :, None]
    xs = corner[:, 0, None, None] + span[None, None, :]
    return corner, ys, xs, sink_reg, sink_l


def paint_cif(config: Cif, rescaler, width_height, anns, meta):
    keypoint_sets = rescaler.keypoint_sets(anns)
    bg_mask = rescaler.bg_mask(
        anns, width_height, crowd_margin=(config.side_length - 1) / 2)
    valid_area = rescaler.valid_area(meta)

    n_fields = len(config.meta.keypoints)
    side = config.side_length
    planes = PaddedPlanes(n_fields, *bg_mask.shape, config.padding)

    conf = planes.plane(0.0)
    reg_x = planes.plane(np.nan)
    reg_y = planes.plane(np.nan)
    bmin = planes.plane(np.nan)
    scale = planes.plane(np.nan)
    planes.paint_region(conf, ~bg_mask, np.nan)
    barrier = planes.barrier_lookup(~bg_mask, 1.0)

    if keypoint_sets:
        kps = np.stack(keypoint_sets)  # (I, K, 3)
        scales = joint_scales(rescaler, keypoint_sets, config.meta.sigmas)

        inst, joint = np.nonzero(kps[:, :, 2] > config.v_threshold)
        xy = kps[inst, joint, :2]
        corner, ys, xs, sink_reg, sink_l = patch_candidates(
            xy, side, config.padding)
        in_bounds = ((corner[:, 0] >= 0)
                     & (corner[:, 0] + side <= planes.wp)
                     & (corner[:, 1] >= 0)
                     & (corner[:, 1] + side <= planes.hp))
        keep = np.flatnonzero(in_bounds)

        values = scales[inst[keep], joint[keep]]
        assert np.all(np.isnan(values)
                      | ((values > 0.0) & (values < 100.0))), \
            'implausible joint scale'

        keys = planes.flat_keys(joint[keep, None, None],
                                ys[keep], xs[keep]).ravel()
        metric = sink_l[keep].ravel()
        writer = np.broadcast_to(inst[keep, None, None],
                                 (keep.size, side, side)).ravel()
        won = resolve(keys, metric, writer, barrier[keys], ties='first')

        cells = keys[won]
        conf[cells] = 1.0
        reg_x[cells] = sink_reg[keep][:, 0].reshape(-1)[won]
        reg_y[cells] = sink_reg[keep][:, 1].reshape(-1)[won]
        bmin[cells] = config.bmin / config.meta.stride
        scale[cells] = np.repeat(values, side * side)[won]

    return np.stack([
        planes.cropped(conf, valid_area, 0),
        planes.cropped(reg_x, valid_area, np.nan),
        planes.cropped(reg_y, valid_area, np.nan),
        planes.cropped(bmin, valid_area, np.nan),
        planes.cropped(scale, valid_area, np.nan),
    ], axis=1)
