"""Pair-consistent random crop (semantics of reference
``transforms/pair/crop.py``).

Both frames are cropped with *identical* random draws (the numpy RNG
state is rewound between frames) so their windows coincide — except for a
per-pair camera-shift offset that displaces frame 2's window to simulate
camera motion. Geometry is shared with the single-image crop
(:mod:`..geometry`).
"""

import copy
import logging

import numpy as np

from .. import geometry
from ..preprocess import Preprocess

LOG = logging.getLogger(__name__)


class Crop(Preprocess):
    def __init__(self, long_edge, *, use_area_of_interest=True, max_shift=0):
        self.long_edge = long_edge
        self.use_area_of_interest = use_area_of_interest
        self.max_shift = max_shift

    def _shared_window(self, all_anns, metas):
        """The (valid_area, interest_region) both frames crop against:
        frame 2's annotations unless only frame 1 has any."""
        if not self.use_area_of_interest:
            valid_area = metas[0]['valid_area']
            return valid_area, valid_area
        source = 0 if (all_anns[0] and not all_anns[1]) else 1
        valid_area = metas[source]['valid_area']
        return valid_area, geometry.interest_region(all_anns[source],
                                                    valid_area)

    def _crop_frame(self, image, anns, valid_area, region, shift):
        w, h = image.size
        x0 = y0 = 0
        if w > self.long_edge:
            x0 = geometry.sample_crop_origin(
                w - 1, (valid_area[0], valid_area[2]),
                (region[0], region[2]), self.long_edge, shift=shift[0])
        if h > self.long_edge:
            y0 = geometry.sample_crop_origin(
                h - 1, (valid_area[1], valid_area[3]),
                (region[1], region[3]), self.long_edge, shift=shift[1])
        return geometry.cut_window(image, anns, (x0, y0), self.long_edge)

    def __call__(self, images, all_anns, metas):
        metas = copy.deepcopy(metas)
        all_anns = copy.deepcopy(all_anns)

        valid_area, region = self._shared_window(all_anns, metas)
        cam_shift = (np.random.rand(2) - 0.5) * 2.0 * self.max_shift
        shared_rng = np.random.get_state()

        out = []
        for image, anns, meta in zip(images, all_anns, metas):
            np.random.set_state(shared_rng)
            image, ltrb = self._crop_frame(
                image, anns, valid_area, region,
                cam_shift * meta.get('group_i', 1.0))

            meta['offset'] += ltrb[:2]
            geometry.shift_valid_area(meta['valid_area'], ltrb, image.size,
                                      clamp_rb_to_origin=False)
            anns = geometry.clip_bboxes(anns, meta['valid_area'])
            out.append((image, anns, meta))

        return tuple(list(column) for column in zip(*out))
