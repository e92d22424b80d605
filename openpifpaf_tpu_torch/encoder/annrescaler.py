"""Annotation conditioning for target encoding.

Converts COCO-style annotation dicts into the arrays the target painters
consume: keypoint sets in field (stride-divided) coordinates with the
visibility-suppression rules applied, crowd background masks, valid areas,
and instance scale estimates. Covers the behavior of the reference's
``encoder/annrescaler.py:8-310`` with the suppression rules expressed as
array broadcasts instead of per-keypoint loops.

Coordinate conventions: annotation keypoints are (K, 3) [x, y, v] with
v = 0 absent / 1 present-but-hidden / 2 visible; suppression rules operate
in image pixels, scale estimation in field cells.
"""

import logging

import numpy as np

LOG = logging.getLogger(__name__)

#: suppression neighborhoods, in image pixels
_SELFHIDDEN_RADIUS = 32.0
_COLLISION_MIN_RADIUS = 16.0


def _hidden_under_visible(stack):
    """Mask of keypoints with v == 1 that sit within the suppression box
    of some v > 1 keypoint of the same joint in another instance.

    stack: (I, K, 3). Order-free: suppressible keypoints (v == 1) can
    never themselves suppress (that needs v > 1), so there is no cascade.
    """
    v = stack[:, :, 2]
    hidden = v == 1.0
    visible = v > 1.0
    if not (hidden.any() and visible.any()):
        return np.zeros_like(hidden)
    dx = np.abs(stack[:, None, :, 0] - stack[None, :, :, 0])  # (I, I, K)
    dy = np.abs(stack[:, None, :, 1] - stack[None, :, :, 1])
    covered = (dx <= _SELFHIDDEN_RADIUS) & (dy <= _SELFHIDDEN_RADIUS)
    # instance i's joint k is covered if any visible j has it in range
    return hidden & np.any(visible[None, :, :] & covered, axis=1)


def _zero_collisions(sets_bbox):
    """Zero out joints where two instances nearly coincide.

    Sequential over instance pairs on purpose: a joint zeroed by an early
    pair no longer registers as colliding in later pairs (the reference's
    cascade, ``annrescaler.py:37-55``).
    """
    for a, (kps_a, bbox_a) in enumerate(sets_bbox[:-1]):
        for kps_b, bbox_b in sets_bbox[a + 1:]:
            radius = max(_COLLISION_MIN_RADIUS,
                         0.2 * max(bbox_a[2], bbox_a[3],
                                   bbox_b[2], bbox_b[3]))
            near = np.abs(kps_a[:, :2] - kps_b[:, :2]) < radius
            hit = ((kps_a[:, 2] > 0.0) & (kps_b[:, 2] > 0.0)
                   & near[:, 0] & near[:, 1])
            kps_a[hit, 2] = 0.0
            kps_b[hit, 2] = 0.0


def _box_cells(bbox, stride, margin, grid_h, grid_w):
    """Inclusive-exclusive cell rectangle of a margin-expanded box, or
    None when the annotation has no box."""
    if bbox is None:
        return None
    x0, y0, bw, bh = (float(c) / stride for c in bbox)
    left = min(max(int(x0 - margin), 0), grid_w - 1)
    top = min(max(int(y0 - margin), 0), grid_h - 1)
    right = min(max(int(np.ceil(x0 + bw + margin)) + 1, left + 1), grid_w)
    bottom = min(max(int(np.ceil(y0 + bh + margin)) + 1, top + 1), grid_h)
    return left, top, right, bottom


def _grid_shape(width_height, stride):
    return ((width_height[1] - 1) // stride + 1,
            (width_height[0] - 1) // stride + 1)


def _needs_masking(ann):
    """Crowd regions and keypointless instances are don't-care areas."""
    if ann['iscrowd']:
        return True
    has_kp = 'keypoints' in ann and np.any(ann['keypoints'][:, 2] > 0)
    return not has_kp


def _rotated_extent_area(points):
    return ((np.max(points[:, 0]) - np.min(points[:, 0]))
            * (np.max(points[:, 1]) - np.min(points[:, 1])))


class AnnRescaler:
    suppress_selfhidden = True
    suppress_invisible = False
    suppress_collision = False

    def __init__(self, stride, pose=None):
        self.stride = stride
        self.pose = pose
        if pose is not None:
            c = np.cos(np.deg2rad(45))
            s = np.sin(np.deg2rad(45))
            pose_45 = np.copy(pose)
            pose_45[:, :2] = np.einsum('ij,kj->ki',
                                       np.array(((c, -s), (s, c))),
                                       pose_45[:, :2])
            self.pose_45 = pose_45
            self.pose_total_area = _rotated_extent_area(pose)
            self.pose_45_total_area = _rotated_extent_area(pose_45)

    def valid_area(self, meta):
        if 'valid_area' not in meta:
            return None
        return tuple(edge / self.stride for edge in meta['valid_area'])

    def _condition(self, sets_bbox):
        """Apply the configured suppression rules in place, then rescale
        keypoints to field coordinates."""
        if self.suppress_collision:
            _zero_collisions(sets_bbox)
        keypoint_sets = [kps for kps, _ in sets_bbox]

        if self.suppress_invisible:
            for kps in keypoint_sets:
                kps[kps[:, 2] < 2.0, 2] = 0.0
        elif self.suppress_selfhidden and len(keypoint_sets) > 1:
            stack = np.stack(keypoint_sets)
            drop = _hidden_under_visible(stack)
            for kps, drop_row in zip(keypoint_sets, drop):
                kps[drop_row, 2] = 0.0

        for kps in keypoint_sets:
            kps[:, :2] /= self.stride
        return keypoint_sets

    def keypoint_sets(self, anns):
        """Non-crowd keypoint sets in field coordinates."""
        sets_bbox = [(np.copy(ann['keypoints']), ann['bbox'])
                     for ann in anns if not ann['iscrowd']]
        if not sets_bbox:
            return []
        return self._condition(sets_bbox)

    def bg_mask(self, anns, width_height, *, crowd_margin):
        """True where targets may be painted; False inside crowd regions
        and keypointless instances."""
        grid_h, grid_w = _grid_shape(width_height, self.stride)
        mask = np.ones((grid_h, grid_w), dtype=np.bool_)
        for ann in anns:
            if not _needs_masking(ann):
                continue
            rect = _box_cells(ann.get('bbox'), self.stride, crowd_margin,
                              grid_h, grid_w)
            if rect is None:
                continue
            left, top, right, bottom = rect
            mask[top:bottom, left:right] = False
        return mask

    def scale(self, keypoints):
        """Instance scale estimate in field cells.

        sqrt of the visible-keypoint bounding area, corrected by how much
        of the canonical pose the visible subset spans (evaluated both
        upright and at 45° so elongated part subsets don't explode the
        correction). NaN when fewer than 3 joints are visible or the
        estimate degenerates.
        """
        visible = keypoints[:, 2] > 0
        if np.sum(visible) < 3:
            return np.nan

        area = _rotated_extent_area(keypoints[visible])
        factor = 1.0
        if self.pose is not None:
            subset_area = _rotated_extent_area(self.pose[visible])
            subset_area_45 = _rotated_extent_area(self.pose_45[visible])
            ratio = (self.pose_total_area / subset_area
                     if subset_area > 0.1 else np.inf)
            ratio_45 = (self.pose_45_total_area / subset_area_45
                        if subset_area_45 > 0.1 else np.inf)
            factor = np.sqrt(min(ratio, ratio_45))
            if np.isinf(factor):
                return np.nan

        scale = np.sqrt(area) * min(5.0, factor)
        return np.nan if scale < 0.1 else scale


class TrackingAnnRescaler(AnnRescaler):
    """AnnRescaler over (frame1, frame2) annotation pairs (reference
    ``annrescaler.py:232-310``): keypoint sets concatenate both frames of
    each track, and the crowd mask is the bounding rectangle of all
    don't-care boxes from either frame."""

    def bg_mask(self, anns, width_height, *, crowd_margin):
        anns1, anns2 = anns
        grid_h, grid_w = _grid_shape(width_height, self.stride)
        mask = np.ones((grid_h, grid_w), dtype=np.bool_)

        rects = [
            rect for ann in anns1 + anns2 if _needs_masking(ann)
            for rect in [_box_cells(ann.get('bbox'), self.stride,
                                    crowd_margin, grid_h, grid_w)]
            if rect is not None
        ]
        if rects:
            rects = np.asarray(rects)
            left, top = rects[:, 0].min(), rects[:, 1].min()
            right, bottom = rects[:, 2].max(), rects[:, 3].max()
            if top < bottom and left < right:
                mask[top:bottom, left:right] = False
        return mask

    def keypoint_sets(self, anns):
        anns1, anns2 = anns
        by_track = {ann['track_id']: ann for ann in anns1
                    if 'track_id' in ann}
        sets_bbox = []
        for ann2 in anns2:
            if ann2['iscrowd'] or ann2.get('track_id') not in by_track:
                continue
            ann1 = by_track[ann2['track_id']]
            joined = np.concatenate((ann1['keypoints'], ann2['keypoints']),
                                    axis=0)
            sets_bbox.append((joined, ann2['bbox']))
        if not sets_bbox:
            return []

        # note: selfhidden suppression does not apply across frames
        # (reference annrescaler.py:289-300 skips it for pairs)
        if self.suppress_collision:
            _zero_collisions(sets_bbox)
        keypoint_sets = [kps for kps, _ in sets_bbox]
        if self.suppress_invisible:
            for kps in keypoint_sets:
                kps[kps[:, 2] < 2.0, 2] = 0.0
        for kps in keypoint_sets:
            kps[:, :2] /= self.stride
        return keypoint_sets
