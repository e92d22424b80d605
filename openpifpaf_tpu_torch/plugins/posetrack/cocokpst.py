"""CocoKpSt: the tracking heads on still COCO images (port of the head-meta
half of ``openpifpaf_tpu/plugins/posetrack/cocokpst.py``: the metas and
the flags). Its train and val loaders (the pair transforms, the Tcaf
encoder) are tracking training, not yet ported (ROADMAP A10): they
raise."""

import argparse

from ... import headmeta
from ...datasets import DataModule
from ..coco.cocokp import CocoKp
from ..coco.constants import (
    COCO_KEYPOINTS,
    COCO_PERSON_SKELETON,
    COCO_PERSON_SIGMAS,
    COCO_PERSON_SCORE_WEIGHTS,
    COCO_UPRIGHT_POSE,
    DENSER_COCO_PERSON_CONNECTIONS,
)


class CocoKpSt(DataModule):
    max_shift = 30.0

    def __init__(self):
        super().__init__()

        cif = headmeta.TSingleImageCif(
            'cif', 'cocokpst',
            keypoints=COCO_KEYPOINTS,
            sigmas=COCO_PERSON_SIGMAS,
            pose=COCO_UPRIGHT_POSE,
            draw_skeleton=COCO_PERSON_SKELETON,
            score_weights=COCO_PERSON_SCORE_WEIGHTS)
        caf = headmeta.TSingleImageCaf(
            'caf', 'cocokpst',
            keypoints=COCO_KEYPOINTS,
            sigmas=COCO_PERSON_SIGMAS,
            pose=COCO_UPRIGHT_POSE,
            skeleton=COCO_PERSON_SKELETON)
        dcaf = headmeta.TSingleImageCaf(
            'caf25', 'cocokpst',
            keypoints=COCO_KEYPOINTS,
            sigmas=COCO_PERSON_SIGMAS,
            pose=COCO_UPRIGHT_POSE,
            skeleton=DENSER_COCO_PERSON_CONNECTIONS,
            sparse_skeleton=COCO_PERSON_SKELETON,
            only_in_field_of_view=True)
        tcaf = headmeta.Tcaf(
            'tcaf', 'cocokpst',
            keypoints_single_frame=COCO_KEYPOINTS,
            sigmas_single_frame=COCO_PERSON_SIGMAS,
            pose_single_frame=COCO_UPRIGHT_POSE,
            draw_skeleton_single_frame=COCO_PERSON_SKELETON,
            only_in_field_of_view=True)

        for meta in (cif, caf, dcaf, tcaf):
            meta.upsample_stride = CocoKp.upsample_stride
        self.head_metas = ([cif, caf, dcaf, tcaf] if CocoKp.with_dense
                           else [cif, caf, tcaf])

    @classmethod
    def cli(cls, parser: argparse.ArgumentParser):
        group = parser.add_argument_group('data module CocoKpSt')
        group.add_argument('--cocokpst-max-shift',
                           default=cls.max_shift, type=float)

    @classmethod
    def configure(cls, args: argparse.Namespace):
        cls.max_shift = args.cocokpst_max_shift

    def train_loader(self):
        raise NotImplementedError(
            'cocokpst training (the pair transforms, the Tcaf encoder and '
            'loss) is not yet ported to PyTorch (ROADMAP A10)')

    def val_loader(self):
        raise NotImplementedError(
            'cocokpst training (the pair transforms, the Tcaf encoder and '
            'loss) is not yet ported to PyTorch (ROADMAP A10)')
