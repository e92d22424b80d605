"""Shared crop geometry.

One implementation of window sampling, annotation translation, valid-area
propagation and bbox clipping, used by both the single-image ``Crop`` and
the tracking ``pair.Crop`` (the reference duplicates this logic between
``transforms/crop.py:12-168`` and ``transforms/pair/crop.py``).
"""

import numpy as np


def _clamp_interval(lo, length, limit):
    lo = np.clip(lo, 0, limit)
    return lo, np.clip(length, 0, limit - lo)


def interest_region(anns, valid_area, margin=50):
    """Bounding interval of all non-crowd boxes, padded by ``margin`` px
    and intersected with the valid area; the valid area itself when the
    scene has no annotations."""
    corners = [c for ann in anns if not ann.get('iscrowd', False)
               for c in (ann['bbox'][:2], ann['bbox'][:2] + ann['bbox'][2:])]
    if not corners:
        return valid_area
    corners = np.stack(corners, axis=0)
    lo = np.min(corners, axis=0) - margin
    hi = np.max(corners, axis=0) + margin

    left = np.clip(lo[0], valid_area[0], valid_area[0] + valid_area[2] - 1)
    top = np.clip(lo[1], valid_area[1], valid_area[1] + valid_area[3] - 1)
    right = np.clip(hi[0], left + 1, valid_area[0] + valid_area[2])
    bottom = np.clip(hi[1], top + 1, valid_area[1] + valid_area[3])
    return (left, top, right - left, bottom - top)


def sample_crop_origin(image_length, valid, interest, crop_length,
                       *, tail=0.1, shift=0.0):
    """Random 1-d crop origin biased toward the interest interval.

    ``valid`` and ``interest`` are (min, length) pixel intervals. The
    random draw is "sticky": uniform over [-tail, 1+tail] clipped to
    [0, 1], so the crop hugs an interval end with probability ~tail each.
    ``shift`` nudges the normalized draw (used for synthetic camera motion
    between tracking frames). Consumes exactly one np.random draw.
    """
    if image_length <= crop_length:
        return 0
    valid_min, valid_length = _clamp_interval(*valid, image_length)
    interest_min, interest_length = _clamp_interval(*interest, image_length)

    draw = np.clip(-tail + 2 * tail * np.random.rand(), 0.0, 1.0)

    if interest_length > crop_length:
        # the interest region alone over-fills the crop: slide within it
        draw = np.clip(draw + shift / interest_length, 0.0, 1.0)
        return int(interest_min + (interest_length - crop_length) * draw)

    # origins that keep the whole interest region inside the crop,
    # narrowed to the valid area (or the image when the valid area is
    # itself smaller than the crop)
    lo = interest_min + interest_length - crop_length
    hi = interest_min
    if valid_length > crop_length:
        bound_min, bound_len = valid_min, valid_length
    else:
        bound_min, bound_len = 0, image_length
    lo = max(lo, bound_min)
    hi = max(lo, min(hi, bound_min + bound_len - crop_length))
    lo = np.clip(lo, 0, image_length - crop_length)
    hi = np.clip(hi, 0, image_length - crop_length)

    draw = np.clip(draw + shift / (hi - lo + 1e-3), 0.0, 1.0)
    return int(lo + (hi - lo) * draw)


def cut_window(image, anns, origin, crop_length):
    """Crop ``image`` at ``origin`` (x, y) to at most ``crop_length`` per
    side and translate annotations into window coordinates."""
    w, h = image.size
    x0, y0 = origin
    ltrb = np.array([x0, y0,
                     x0 + min(crop_length, w - x0),
                     y0 + min(crop_length, h - y0)])
    image = image.crop(tuple(ltrb))
    for ann in anns:
        ann['keypoints'][:, 0] -= x0
        ann['keypoints'][:, 1] -= y0
        ann['bbox'][0] -= x0
        ann['bbox'][1] -= y0
    return image, ltrb


def shift_valid_area(valid_area, ltrb, new_wh, *, clamp_rb_to_origin):
    """Valid area after cropping at ``ltrb``, in place.

    clamp_rb_to_origin: floor the right-bottom corner at the shifted
    origin (single-image semantics) instead of at zero (pair semantics).
    """
    origin = valid_area[:2].copy()
    extent = valid_area[2:].copy()
    valid_area[:2] = np.maximum(0.0, origin - ltrb[:2])
    rb = origin + extent - ltrb[:2]
    rb = np.maximum(valid_area[:2] if clamp_rb_to_origin else 0.0, rb)
    rb = np.minimum(new_wh, rb)
    valid_area[2:] = rb - valid_area[:2]


def clip_bboxes(anns, valid_area):
    """Clip each bbox to the valid area (keypoints untouched); drop
    annotations whose clipped box is empty."""
    area_rb = valid_area[:2] + valid_area[2:]
    kept = []
    for ann in anns:
        rb = ann['bbox'][:2] + ann['bbox'][2:]
        ann['bbox'][:2] = np.maximum(valid_area[:2], ann['bbox'][:2])
        rb = np.minimum(area_rb, np.maximum(ann['bbox'][:2], rb))
        ann['bbox'][2:] = rb - ann['bbox'][:2]
        if ann['bbox'][2] > 0.0 and ann['bbox'][3] > 0.0:
            kept.append(ann)
    return kept
