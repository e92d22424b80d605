"""Posetrack/MOT annotation conditioning (copy of
``openpifpaf_tpu/plugins/posetrack/normalize.py``).

Posetrack ground truth needs repairs before encoding: polygon ignore
regions become crowd annotations, annotated keypoints are marked visible
(the dataset doesn't distinguish v=1/v=2), out-of-frame keypoints are
dropped, and missing boxes are filled. The helpers are shared with the
dataset loaders in :mod:`.datasets`; the transform classes expose the
same standalone API as the reference for custom pipelines.
"""

import copy
import logging

import numpy as np

from ...transforms import Preprocess

LOG = logging.getLogger(__name__)


def ignore_region_crowds(image_info):
    """Crowd annotations from the frame's polygon ignore regions."""
    regions = zip(image_info.get('ignore_regions_x', []),
                  image_info.get('ignore_regions_y', []))
    out = []
    for xs, ys in regions:
        if not xs or not ys:
            continue
        out.append({
            'bbox': [min(xs), min(ys),
                     max(xs) - min(xs), max(ys) - min(ys)],
            'keypoints': [(x, y, 0.0) for x, y in zip(xs, ys)],
            'iscrowd': True,
            'track_id': -1,
        })
    return out


def conditioned_keypoints(keypoints, valid_area, *, fix_annotations=True):
    """(K, 3) float32 keypoints with posetrack repairs applied."""
    kps = np.asarray(keypoints, dtype=np.float32).reshape(-1, 3)
    # posetrack marks annotated keypoints v=1 without a hidden/visible
    # distinction; treat all annotated as visible
    kps[kps[:, 2] > 0.0, 2] = 2.0
    if fix_annotations:
        # the dataset contains out-of-frame "annotated" joints
        x0, y0, w, h = valid_area
        kps[kps[:, 0] < x0, 2] = 0.0
        kps[kps[:, 1] < y0, 2] = 0.0
        kps[kps[:, 0] > x0 + w, 2] = 0.0
        kps[kps[:, 1] > y0 + h, 2] = 0.0
    return kps


def fresh_meta(width, height):
    return {
        'offset': np.array((0.0, 0.0)),
        'scale': np.array((1.0, 1.0)),
        'rotation': {'angle': 0.0, 'width': None, 'height': None},
        'valid_area': np.array((0.0, 0.0, width - 1, height - 1)),
        'hflip': False,
        'width_height': np.array((width, height)),
    }


class NormalizePosetrack(Preprocess):
    """Standalone transform over raw posetrack samples: ``anns`` is the
    {'image': image_info, 'annotations': [...]} record of one frame."""

    def __init__(self, ignore_missing_bbox=False, fix_annotations=True):
        self.ignore_missing_bbox = ignore_missing_bbox
        self.fix_annotations = fix_annotations

    def _condition(self, ann, valid_area, image_id):
        ann['image_id'] = image_id
        ann['keypoints'] = conditioned_keypoints(
            ann['keypoints'], valid_area,
            fix_annotations=self.fix_annotations)

        if 'bbox' in ann:
            ann['bbox'] = np.asarray(ann['bbox'], dtype=np.float32)
        else:
            ann['bbox'] = np.zeros((4,), dtype=np.float32)
            if not self.ignore_missing_bbox:
                assert not np.any(ann['keypoints'][:, 2] > 0.0), \
                    'annotation with keypoints but no bbox'
        if 'bbox_head' in ann:
            ann['bbox_head'] = np.asarray(ann['bbox_head'],
                                          dtype=np.float32)

        if 'iscrowd' not in ann:
            ann['iscrowd'] = False
            assert len(ann['keypoints']) == 17
        if not ann['iscrowd']:
            # posetrack never annotates ears
            assert ann['keypoints'][3, 2] == 0.0
            assert ann['keypoints'][4, 2] == 0.0
        return ann

    def __call__(self, image, anns, meta=None):
        meta = copy.deepcopy(meta)
        w, h = image.size
        defaults = fresh_meta(w, h)
        if meta is None:
            meta = defaults
        else:
            for key, value in defaults.items():
                meta.setdefault(key, value)

        image_info = anns['image']
        frame_anns = (copy.deepcopy(anns['annotations'])
                      + ignore_region_crowds(image_info))
        frame_anns = [
            self._condition(ann, meta['valid_area'],
                            image_info['frame_id'])
            for ann in frame_anns
        ]
        return image, frame_anns, meta


class NormalizeMOT(Preprocess):
    """Minimal conditioning for MOT-format ground truth."""

    def __call__(self, image, anns, meta=None):
        anns = copy.deepcopy(anns)
        for ann in anns:
            ann['keypoints'] = np.asarray(
                ann['keypoints'], dtype=np.float32).reshape(-1, 3)
            ann['bbox'] = np.asarray(ann['bbox'], dtype=np.float32)
            ann.pop('segmentation', None)

        if meta is None:
            w, h = image.size
            meta = fresh_meta(w, h)
            meta['valid_area'] = np.array((0.0, 0.0, w, h))
            del meta['rotation']
        return image, anns, meta
