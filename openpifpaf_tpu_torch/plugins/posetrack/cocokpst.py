"""CocoKpSt: tracking training from still COCO images (copy of
``openpifpaf_tpu/plugins/posetrack/cocokpst.py``): each COCO image becomes
a pair of frames that the pair transforms de-correlate, encoded by the
CIF/CAF encoders on the first frame and by Tcaf across the pair."""

import argparse

from ... import encoder, headmeta, transforms
from ...datasets import DataModule, collate
from ...datasets.loader import Loader
from ...transforms.pair import SingleImage as S
from ..coco.cocokp import CocoKp
from ..coco.dataset import CocoDataset
from ..coco.constants import (
    COCO_CATEGORIES,
    COCO_KEYPOINTS,
    COCO_PERSON_SKELETON,
    COCO_PERSON_SIGMAS,
    COCO_PERSON_SCORE_WEIGHTS,
    COCO_UPRIGHT_POSE,
    DENSER_COCO_PERSON_CONNECTIONS,
    HFLIP,
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

    def _preprocess(self):
        bmin = CocoKp.bmin
        if len(self.head_metas) == 4:
            encoders = (
                encoder.SingleImage(encoder.Cif(self.head_metas[0], bmin=bmin)),
                encoder.SingleImage(encoder.Caf(self.head_metas[1], bmin=bmin)),
                encoder.SingleImage(encoder.Caf(self.head_metas[2], bmin=bmin)),
                encoder.Tcaf(self.head_metas[3], bmin=bmin),
            )
        else:
            encoders = (
                encoder.SingleImage(encoder.Cif(self.head_metas[0], bmin=bmin)),
                encoder.SingleImage(encoder.Caf(self.head_metas[1], bmin=bmin)),
                encoder.Tcaf(self.head_metas[2], bmin=bmin),
            )

        if not CocoKp.augmentation:
            return transforms.Compose([
                transforms.NormalizeAnnotations(),
                transforms.RescaleAbsolute(CocoKp.square_edge),
                transforms.CenterPad(CocoKp.square_edge),
                transforms.pair.ImageToTracking(),
                S(transforms.EVAL_TRANSFORM),
                transforms.pair.Encoders(encoders),
            ])

        if CocoKp.extended_scale:
            rescale_t = transforms.RescaleRelative(
                scale_range=(0.25 * CocoKp.rescale_images,
                             2.0 * CocoKp.rescale_images),
                power_law=True, stretch_range=(0.75, 1.33))
        else:
            rescale_t = transforms.RescaleRelative(
                scale_range=(0.4 * CocoKp.rescale_images,
                             2.0 * CocoKp.rescale_images),
                power_law=True, stretch_range=(0.75, 1.33))

        return transforms.Compose([
            transforms.NormalizeAnnotations(),
            transforms.pair.ImageToTracking(),
            transforms.RandomApply(transforms.pair.RandomizeOneFrame(), 0.2),
            S(transforms.RandomApply(
                transforms.HFlip(COCO_KEYPOINTS, HFLIP), 0.5)),
            S(rescale_t),
            S(transforms.RandomChoice(
                [transforms.RotateBy90(angle_perturbation=30.0, prepad=True),
                 transforms.RotateUniform(30.0)],
                [CocoKp.orientation_invariant, 0.4])),
            transforms.pair.Crop(CocoKp.square_edge, max_shift=self.max_shift),
            transforms.pair.Pad(CocoKp.square_edge, max_shift=self.max_shift),
            S(transforms.RandomApply(transforms.Blur(), CocoKp.blur)),
            S(transforms.TRAIN_TRANSFORM),
            transforms.pair.Encoders(encoders),
        ])

    def train_loader(self):
        train_data = CocoDataset(
            image_dir=CocoKp.train_image_dir,
            ann_file=CocoKp.train_annotations,
            preprocess=self._preprocess(),
            annotation_filter=True,
            min_kp_anns=CocoKp.min_kp_anns,
            category_ids=[1],
        )
        return Loader(
            train_data, batch_size=max(1, self.batch_size // 2),
            shuffle=not CocoKp.debug and CocoKp.augmentation,
            num_workers=self.loader_workers, drop_last=True,
            collate_fn=collate.collate_tracking_images_targets_meta)

    def val_loader(self):
        val_data = CocoDataset(
            image_dir=CocoKp.val_image_dir,
            ann_file=CocoKp.val_annotations,
            preprocess=self._preprocess(),
            annotation_filter=True,
            min_kp_anns=CocoKp.min_kp_anns,
            category_ids=[1],
        )
        return Loader(
            val_data, batch_size=max(1, self.batch_size // 2), shuffle=False,
            num_workers=self.loader_workers, drop_last=True,
            collate_fn=collate.collate_tracking_images_targets_meta)

    def _eval_preprocess(self):
        return transforms.Compose([
            *CocoKp.common_eval_preprocess(),
            transforms.ToAnnotations([
                transforms.ToKpAnnotations(
                    COCO_CATEGORIES,
                    keypoints_by_category={1: self.head_metas[0].keypoints},
                    skeleton_by_category={1: self.head_metas[1].skeleton},
                ),
                transforms.ToCrowdAnnotations(COCO_CATEGORIES),
            ]),
            transforms.EVAL_TRANSFORM,
        ])

    def eval_loader(self):
        eval_data = CocoDataset(
            image_dir=CocoKp.eval_image_dir,
            ann_file=CocoKp.eval_annotations,
            preprocess=self._eval_preprocess(),
            annotation_filter=CocoKp.eval_annotation_filter,
            min_kp_anns=(CocoKp.min_kp_anns
                         if CocoKp.eval_annotation_filter else 0),
            category_ids=[1] if CocoKp.eval_annotation_filter else [],
        )
        return Loader(
            eval_data, batch_size=self.batch_size, shuffle=False,
            num_workers=self.loader_workers, drop_last=False,
            collate_fn=collate.collate_images_anns_meta)

    def metrics(self):
        from ... import metric
        from ..coco.dataset import CocoIndex
        index = CocoIndex(CocoKp.eval_annotations)
        gt_by_image = {
            image_id: index.annotations(image_id, [1])
            for image_id in index.images
        }
        return [metric.Coco(
            gt_by_image, max_per_image=20, category_ids=[1],
            iou_type='keypoints',
            keypoint_oks_sigmas=COCO_PERSON_SIGMAS)]
