"""Random square crop biased toward the annotated region (semantics of
reference ``transforms/crop.py:12-168``; geometry shared with the pair
crop in :mod:`.geometry`)."""

import copy
import logging

from . import geometry
from .preprocess import Preprocess

LOG = logging.getLogger(__name__)


class Crop(Preprocess):
    """Random crop to a square of side ``long_edge``, biased towards the
    area of interest (annotated region ±50px)."""

    def __init__(self, long_edge, use_area_of_interest=True):
        self.long_edge = long_edge
        self.use_area_of_interest = use_area_of_interest

    # kept as staticmethods: pair.Crop and external code use these entry
    # points under the reference's names
    area_of_interest = staticmethod(geometry.interest_region)

    @staticmethod
    def random_location_1d(image_length, valid_min, valid_length,
                           interest_min, interest_length, crop_length,
                           tail=0.1, shift=0.0):
        return geometry.sample_crop_origin(
            image_length, (valid_min, valid_length),
            (interest_min, interest_length), crop_length,
            tail=tail, shift=shift)

    def __call__(self, image, anns, meta):
        meta = copy.deepcopy(meta)
        anns = copy.deepcopy(anns)
        valid_area = meta['valid_area']

        region = (geometry.interest_region(anns, valid_area)
                  if self.use_area_of_interest else valid_area)
        w, h = image.size
        x0 = y0 = 0
        if w > self.long_edge:
            x0 = geometry.sample_crop_origin(
                w - 1, (valid_area[0], valid_area[2]),
                (region[0], region[2]), self.long_edge)
        if h > self.long_edge:
            y0 = geometry.sample_crop_origin(
                h - 1, (valid_area[1], valid_area[3]),
                (region[1], region[3]), self.long_edge)

        image, ltrb = geometry.cut_window(image, anns, (x0, y0),
                                          self.long_edge)
        meta['offset'] += ltrb[:2]
        geometry.shift_valid_area(meta['valid_area'], ltrb, image.size,
                                  clamp_rb_to_origin=True)
        anns = geometry.clip_bboxes(anns, meta['valid_area'])
        return image, anns, meta
