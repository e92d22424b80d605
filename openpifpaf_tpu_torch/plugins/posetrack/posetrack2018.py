"""Posetrack2018 data module (copy of
``openpifpaf_tpu/plugins/posetrack/posetrack2018.py``): train and val
loaders over pairs of frames (0, -1) of each annotated sequence, and an
eval loader over single frames that emits ``eval_reset`` between
sequences."""

import argparse

from ... import encoder, headmeta, transforms
from ...datasets import DataModule, collate
from ...datasets.loader import Loader
from ...transforms.pair import SingleImage as S
from .datasets import Posetrack2018 as Posetrack2018Dataset
from . import constants


class Posetrack2018(DataModule):
    train_annotations = 'data-posetrack2018/annotations/train/*.json'
    val_annotations = 'data-posetrack2018/annotations/val/*.json'
    eval_annotations = val_annotations
    data_root = 'data-posetrack2018'

    square_edge = 385
    with_dense = False
    augmentation = True
    rescale_images = 1.0
    upsample_stride = 1
    min_kp_anns = 1
    bmin = 0.1
    max_shift = 30.0
    sample_pairing = 0.0
    image_aug = 0.0
    eval_long_edge = 801
    eval_extended_scale = False
    eval_orientation_invariant = 0.0
    ablation_without_tcaf = False

    def __init__(self):
        super().__init__()

        cif = headmeta.TSingleImageCif(
            'cif', 'posetrack2018',
            keypoints=constants.KEYPOINTS,
            sigmas=constants.SIGMAS,
            pose=constants.UPRIGHT_POSE,
            draw_skeleton=constants.SKELETON)
        caf = headmeta.TSingleImageCaf(
            'caf', 'posetrack2018',
            keypoints=constants.KEYPOINTS,
            sigmas=constants.SIGMAS,
            pose=constants.UPRIGHT_POSE,
            skeleton=constants.SKELETON)
        dcaf = headmeta.TSingleImageCaf(
            'caf25', 'posetrack2018',
            keypoints=constants.KEYPOINTS,
            sigmas=constants.SIGMAS,
            pose=constants.UPRIGHT_POSE,
            skeleton=constants.DENSER_CONNECTIONS,
            sparse_skeleton=constants.SKELETON,
            only_in_field_of_view=True)
        tcaf = headmeta.Tcaf(
            'tcaf', 'posetrack2018',
            keypoints_single_frame=constants.KEYPOINTS,
            sigmas_single_frame=constants.SIGMAS,
            pose_single_frame=constants.UPRIGHT_POSE,
            draw_skeleton_single_frame=constants.SKELETON,
            only_in_field_of_view=True)

        for meta in (cif, caf, dcaf, tcaf):
            meta.upsample_stride = self.upsample_stride
        self.head_metas = ([cif, caf, dcaf, tcaf] if self.with_dense
                           else [cif, caf, tcaf])
        if self.ablation_without_tcaf:
            self.head_metas = [m for m in self.head_metas
                               if not isinstance(m, headmeta.Tcaf)]

    @classmethod
    def cli(cls, parser: argparse.ArgumentParser):
        group = parser.add_argument_group('data module Posetrack2018')
        group.add_argument('--posetrack2018-train-annotations',
                           default=cls.train_annotations)
        group.add_argument('--posetrack2018-val-annotations',
                           default=cls.val_annotations)
        group.add_argument('--posetrack2018-data-root',
                           default=cls.data_root)
        group.add_argument('--posetrack-square-edge',
                           default=cls.square_edge, type=int)
        group.add_argument('--posetrack-with-dense',
                           default=False, action='store_true')
        group.add_argument('--posetrack-no-augmentation',
                           dest='posetrack_augmentation',
                           default=True, action='store_false')
        group.add_argument('--posetrack-rescale-images',
                           default=cls.rescale_images, type=float)
        group.add_argument('--posetrack-upsample',
                           default=cls.upsample_stride, type=int)
        group.add_argument('--posetrack-bmin', default=cls.bmin, type=float)
        group.add_argument('--posetrack-max-shift',
                           default=cls.max_shift, type=float)
        group.add_argument('--posetrack-sample-pairing',
                           default=cls.sample_pairing, type=float,
                           help='probability of SamplePairing augmentation')
        group.add_argument('--posetrack2018-eval-annotations',
                           default=cls.eval_annotations)
        group.add_argument('--posetrack-min-kp-anns',
                           default=cls.min_kp_anns, type=int,
                           help='minimum number of keypoint annotations')
        group.add_argument('--posetrack-image-augmentations',
                           default=cls.image_aug, type=float,
                           help='autocontrast/equalize/invert/solarize '
                                'probability')
        group.add_argument('--posetrack-eval-long-edge',
                           default=cls.eval_long_edge, type=int)
        group.add_argument('--posetrack-eval-extended-scale',
                           default=False, action='store_true')
        group.add_argument('--posetrack-eval-orientation-invariant',
                           default=cls.eval_orientation_invariant,
                           type=float)
        group.add_argument('--posetrack-ablation-without-tcaf',
                           default=False, action='store_true')

    @classmethod
    def configure(cls, args: argparse.Namespace):
        cls.train_annotations = args.posetrack2018_train_annotations
        cls.val_annotations = args.posetrack2018_val_annotations
        cls.eval_annotations = cls.val_annotations
        cls.data_root = args.posetrack2018_data_root
        cls.square_edge = args.posetrack_square_edge
        cls.with_dense = args.posetrack_with_dense
        cls.augmentation = args.posetrack_augmentation
        cls.rescale_images = args.posetrack_rescale_images
        cls.upsample_stride = args.posetrack_upsample
        cls.bmin = args.posetrack_bmin
        cls.max_shift = args.posetrack_max_shift
        cls.sample_pairing = args.posetrack_sample_pairing
        cls.eval_annotations = args.posetrack2018_eval_annotations
        cls.min_kp_anns = args.posetrack_min_kp_anns
        cls.image_aug = args.posetrack_image_augmentations
        cls.eval_long_edge = args.posetrack_eval_long_edge
        cls.eval_extended_scale = args.posetrack_eval_extended_scale
        cls.eval_orientation_invariant = \
            args.posetrack_eval_orientation_invariant
        cls.ablation_without_tcaf = args.posetrack_ablation_without_tcaf

    def _encoders(self):
        if len(self.head_metas) == 4:
            return (
                encoder.SingleImage(encoder.Cif(self.head_metas[0], bmin=self.bmin)),
                encoder.SingleImage(encoder.Caf(self.head_metas[1], bmin=self.bmin)),
                encoder.SingleImage(encoder.Caf(self.head_metas[2], bmin=self.bmin)),
                encoder.Tcaf(self.head_metas[3], bmin=self.bmin),
            )
        return (
            encoder.SingleImage(encoder.Cif(self.head_metas[0], bmin=self.bmin)),
            encoder.SingleImage(encoder.Caf(self.head_metas[1], bmin=self.bmin)),
            encoder.Tcaf(self.head_metas[2], bmin=self.bmin),
        )

    def _preprocess(self):
        encoders = self._encoders()

        if not self.augmentation:
            return transforms.Compose([
                S(transforms.NormalizeAnnotations()),
                S(transforms.RescaleAbsolute(self.square_edge)),
                S(transforms.CenterPad(self.square_edge)),
                S(transforms.EVAL_TRANSFORM),
                transforms.pair.Encoders(encoders),
            ])

        rescale_t = transforms.RescaleRelative(
            scale_range=(0.4 * self.rescale_images,
                         2.0 * self.rescale_images),
            power_law=True, stretch_range=(0.75, 1.33))

        return transforms.Compose([
            S(transforms.NormalizeAnnotations()),
            S(transforms.RandomApply(
                transforms.HFlip(constants.KEYPOINTS, constants.HFLIP), 0.5)),
            S(rescale_t),
            transforms.pair.Crop(self.square_edge, max_shift=self.max_shift),
            transforms.pair.Pad(self.square_edge, max_shift=self.max_shift),
            # reference posetrack2018.py:228-229: group-level blend with the
            # previous sample
            transforms.RandomApply(
                transforms.pair.SamplePairing(), self.sample_pairing),
            self._image_aug_transform(),
            S(transforms.TRAIN_TRANSFORM),
            transforms.pair.Encoders(encoders),
        ])

    def _image_aug_transform(self):
        """--posetrack-image-augmentations: PIL ImageOps augmentations
        (reference posetrack2018.py:231-236)."""
        if not self.image_aug:
            return None
        import PIL.ImageOps
        return S(transforms.RandomChoice([
            transforms.ImageTransform(PIL.ImageOps.autocontrast),
            transforms.ImageTransform(PIL.ImageOps.equalize),
            transforms.ImageTransform(PIL.ImageOps.invert),
            transforms.ImageTransform(PIL.ImageOps.solarize),
        ], [self.image_aug / 4] * 4))

    def train_loader(self):
        train_data = Posetrack2018Dataset(
            self.train_annotations, self.data_root,
            preprocess=self._preprocess(),
            group=(0, -1),
            only_annotated=True)
        return Loader(
            train_data, batch_size=max(1, self.batch_size // 2),
            shuffle=self.augmentation,
            num_workers=self.loader_workers, drop_last=True,
            collate_fn=collate.collate_tracking_images_targets_meta)

    def val_loader(self):
        val_data = Posetrack2018Dataset(
            self.val_annotations, self.data_root,
            preprocess=self._preprocess(),
            group=(0, -1),
            only_annotated=True)
        return Loader(
            val_data, batch_size=max(1, self.batch_size // 2), shuffle=False,
            num_workers=self.loader_workers, drop_last=True,
            collate_fn=collate.collate_tracking_images_targets_meta)

    @classmethod
    def common_eval_preprocess(cls):
        """Eval geometry shared with posetrack2017
        (reference posetrack2018.py:274-305)."""
        rescale_t = None
        if cls.eval_extended_scale:
            assert cls.eval_long_edge
            rescale_t = transforms.DeterministicEqualChoice([
                transforms.RescaleAbsolute(cls.eval_long_edge),
                transforms.RescaleAbsolute(
                    (cls.eval_long_edge - 1) // 2 + 1),
            ], salt=1)
        elif cls.eval_long_edge:
            rescale_t = transforms.RescaleAbsolute(cls.eval_long_edge)

        if cls.batch_size == 1:
            padding_t = transforms.CenterPadTight(16)
        else:
            assert cls.eval_long_edge
            padding_t = transforms.CenterPad(cls.eval_long_edge)

        orientation_t = None
        if cls.eval_orientation_invariant:
            orientation_t = transforms.DeterministicEqualChoice([
                None,
                transforms.RotateBy90(fixed_angle=90),
                transforms.RotateBy90(fixed_angle=180),
                transforms.RotateBy90(fixed_angle=270),
            ], salt=3)

        return [
            transforms.pair.Ungroup(),
            transforms.NormalizeAnnotations(),
            rescale_t,
            padding_t,
            orientation_t,
        ]

    def _eval_preprocess(self):
        return transforms.Compose([
            *self.common_eval_preprocess(),
            transforms.ToAnnotations([
                transforms.ToKpAnnotations(
                    constants.CATEGORIES,
                    keypoints_by_category={1: self.head_metas[0].keypoints},
                    skeleton_by_category={1: self.head_metas[1].skeleton},
                ),
                transforms.ToCrowdAnnotations(constants.CATEGORIES),
            ]),
            transforms.EVAL_TRANSFORM,
        ])

    def eval_loader(self):
        from ...datasets import LoaderWithReset
        eval_data = Posetrack2018Dataset(
            self.eval_annotations, self.data_root,
            preprocess=self._eval_preprocess(),
            group=(0,))
        loader = Loader(
            eval_data, batch_size=self.batch_size, shuffle=False,
            num_workers=self.loader_workers, drop_last=False,
            collate_fn=collate.collate_images_anns_meta)
        # emit eval_reset when the sequence changes so tracking state
        # clears between videos (reference posetrack2018.py eval_loader)
        return LoaderWithReset(loader, 'annotation_file')

    def metrics(self):
        from .metric import Posetrack
        return [Posetrack()]
