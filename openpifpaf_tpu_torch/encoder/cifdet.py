"""CifDet target painter (copy of ``openpifpaf_tpu/encoder/cifdet.py``,
numpy only).

Output (C, 7, H, W): [confidence, x-offset, y-offset, w, h, bmin_reg,
bmin_wh]. Like CIF, each detection contributes one ``side_length``² patch
of candidate writes, resolved globally with first-writer-wins strict-<
semantics — with one extra rule: the winning cell's confidence is NaN
(don't care) when it sits outside the patch's core radius, so only the
center ring trains positively.
"""

import dataclasses
import logging
from typing import ClassVar, Optional

import numpy as np

from .annrescaler import AnnRescalerDet
from .cif import patch_candidates
from .scatter import PaddedPlanes, resolve
from .. import headmeta

LOG = logging.getLogger(__name__)


@dataclasses.dataclass
class CifDet:
    meta: headmeta.CifDet
    rescaler: Optional[AnnRescalerDet] = None
    v_threshold: int = 0
    bmin: float = 1.0  #: in pixels
    visualizer: Optional[object] = None

    side_length: ClassVar[int] = 5
    padding: ClassVar[int] = 10

    def __call__(self, image, anns, meta):
        rescaler = self.rescaler or AnnRescalerDet(
            self.meta.stride, len(self.meta.categories))
        return paint_cifdet(self, rescaler, image.shape[1::-1], anns, meta)


def paint_cifdet(config: CifDet, rescaler, width_height, anns, meta):
    detections = rescaler.detections(anns)
    bg_mask = rescaler.bg_mask(
        anns, width_height, crowd_margin=(config.side_length - 1) / 2)
    valid_area = rescaler.valid_area(meta)

    n_fields = len(config.meta.categories)
    side = config.side_length
    planes = PaddedPlanes(n_fields, *bg_mask.shape[-2:], config.padding)

    conf = planes.plane(0.0)
    reg_x = planes.plane(np.nan)
    reg_y = planes.plane(np.nan)
    w_plane = planes.plane(np.nan)
    h_plane = planes.plane(np.nan)
    bmin_reg = planes.plane(np.nan)
    bmin_wh = planes.plane(np.nan)
    planes.paint_region(conf, ~bg_mask, np.nan)
    barrier = planes.barrier_lookup(~bg_mask, 1.0)

    if detections:
        fields = np.array([cat - 1 for cat, _ in detections])
        boxes = np.stack([bbox for _, bbox in detections])
        centers = boxes[:, :2] + 0.5 * boxes[:, 2:]
        wh = boxes[:, 2:]

        corner, ys, xs, sink_reg, sink_l = patch_candidates(
            centers, side, config.padding)
        in_bounds = ((corner[:, 0] >= 0)
                     & (corner[:, 0] + side <= planes.wp)
                     & (corner[:, 1] >= 0)
                     & (corner[:, 1] + side <= planes.hp))
        keep = np.flatnonzero(in_bounds)
        assert np.all(wh[keep] > 0.0), 'degenerate detection box'

        keys = planes.flat_keys(fields[keep, None, None],
                                ys[keep], xs[keep]).ravel()
        metric = sink_l[keep].ravel()
        writer = np.broadcast_to(np.arange(len(detections))[keep, None,
                                                            None],
                                 (keep.size, side, side)).ravel()
        won = resolve(keys, metric, writer, barrier[keys], ties='first')
        cells = keys[won]

        # outside the core radius the cell resolves a conflict but trains
        # as don't-care rather than positive
        core_radius = (side - 1) / 2.0
        conf[cells] = np.where(metric[won] > core_radius, np.nan, 1.0)
        reg_x[cells] = sink_reg[keep][:, 0].reshape(-1)[won]
        reg_y[cells] = sink_reg[keep][:, 1].reshape(-1)[won]

        expand = np.repeat(np.arange(keep.size), side * side)[won]
        w_plane[cells] = wh[keep][expand, 0]
        h_plane[cells] = wh[keep][expand, 1]
        half_scale = 0.5 * np.minimum(wh[keep][:, 0], wh[keep][:, 1])
        bmins = np.maximum(0.1 * half_scale,
                           config.bmin / config.meta.stride)
        bmin_reg[cells] = bmins[expand]
        bmin_wh[cells] = bmins[expand]

    return np.stack([
        planes.cropped(conf, valid_area, 0),
        planes.cropped(reg_x, valid_area, np.nan),
        planes.cropped(reg_y, valid_area, np.nan),
        planes.cropped(w_plane, valid_area, np.nan),
        planes.cropped(h_plane, valid_area, np.nan),
        planes.cropped(bmin_reg, valid_area, np.nan),
        planes.cropped(bmin_wh, valid_area, np.nan),
    ], axis=1)
