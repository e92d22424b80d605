"""CocoKp data module (copy of the train and val half of
``openpifpaf_tpu/plugins/coco/cocokp.py``, with its flags). Its eval
loader, metrics and ``--coco-eval-*`` flags wait for eval (ROADMAP A8)."""

import argparse

from ... import encoder, headmeta, transforms
from ...configurable import Configurable
from ...datasets import DataModule, collate
from ...datasets.loader import Loader
from .dataset import CocoDataset
from .constants import (
    COCO_KEYPOINTS,
    COCO_PERSON_SKELETON,
    COCO_PERSON_SIGMAS,
    COCO_PERSON_SCORE_WEIGHTS,
    COCO_UPRIGHT_POSE,
    DENSER_COCO_PERSON_CONNECTIONS,
    HFLIP,
)


class CocoKp(DataModule, Configurable):
    debug = False

    train_annotations = 'data-mscoco/annotations/person_keypoints_train2017.json'
    val_annotations = 'data-mscoco/annotations/person_keypoints_val2017.json'
    train_image_dir = 'data-mscoco/images/train2017/'
    val_image_dir = 'data-mscoco/images/val2017/'

    square_edge = 385
    with_dense = False
    extended_scale = False
    orientation_invariant = 0.0
    blur = 0.0
    augmentation = True
    rescale_images = 1.0
    upsample_stride = 1
    min_kp_anns = 1
    bmin = 0.1

    skeleton = COCO_PERSON_SKELETON

    def __init__(self, **kwargs):
        super().__init__(**kwargs)

        cif = headmeta.Cif('cif', 'cocokp',
                           keypoints=COCO_KEYPOINTS,
                           sigmas=COCO_PERSON_SIGMAS,
                           pose=COCO_UPRIGHT_POSE,
                           draw_skeleton=self.skeleton,
                           score_weights=COCO_PERSON_SCORE_WEIGHTS)
        caf = headmeta.Caf('caf', 'cocokp',
                           keypoints=COCO_KEYPOINTS,
                           sigmas=COCO_PERSON_SIGMAS,
                           pose=COCO_UPRIGHT_POSE,
                           skeleton=self.skeleton)
        dcaf = headmeta.Caf('caf25', 'cocokp',
                            keypoints=COCO_KEYPOINTS,
                            sigmas=COCO_PERSON_SIGMAS,
                            pose=COCO_UPRIGHT_POSE,
                            skeleton=DENSER_COCO_PERSON_CONNECTIONS,
                            sparse_skeleton=self.skeleton,
                            only_in_field_of_view=True)

        cif.upsample_stride = self.upsample_stride
        caf.upsample_stride = self.upsample_stride
        dcaf.upsample_stride = self.upsample_stride
        self.head_metas = [cif, caf, dcaf] if self.with_dense else [cif, caf]

    @classmethod
    def cli(cls, parser: argparse.ArgumentParser):
        group = parser.add_argument_group('data module CocoKp')
        group.add_argument('--cocokp-train-annotations',
                           default=cls.train_annotations)
        group.add_argument('--cocokp-val-annotations',
                           default=cls.val_annotations)
        group.add_argument('--cocokp-train-image-dir',
                           default=cls.train_image_dir)
        group.add_argument('--cocokp-val-image-dir',
                           default=cls.val_image_dir)
        group.add_argument('--cocokp-square-edge',
                           default=cls.square_edge, type=int)
        group.add_argument('--cocokp-with-dense',
                           default=False, action='store_true')
        group.add_argument('--cocokp-extended-scale',
                           default=False, action='store_true')
        group.add_argument('--cocokp-orientation-invariant',
                           default=cls.orientation_invariant, type=float)
        group.add_argument('--cocokp-blur', default=cls.blur, type=float)
        group.add_argument('--cocokp-no-augmentation',
                           dest='cocokp_augmentation',
                           default=True, action='store_false')
        group.add_argument('--cocokp-rescale-images',
                           default=cls.rescale_images, type=float)
        group.add_argument('--cocokp-upsample',
                           default=cls.upsample_stride, type=int)
        group.add_argument('--cocokp-min-kp-anns',
                           default=cls.min_kp_anns, type=int)
        group.add_argument('--cocokp-bmin', default=cls.bmin, type=float)

    @classmethod
    def configure(cls, args: argparse.Namespace):
        cls.debug = getattr(args, 'debug', False)
        cls.train_annotations = args.cocokp_train_annotations
        cls.val_annotations = args.cocokp_val_annotations
        cls.train_image_dir = args.cocokp_train_image_dir
        cls.val_image_dir = args.cocokp_val_image_dir

        cls.square_edge = args.cocokp_square_edge
        cls.with_dense = args.cocokp_with_dense
        cls.extended_scale = args.cocokp_extended_scale
        cls.orientation_invariant = args.cocokp_orientation_invariant
        cls.blur = args.cocokp_blur
        cls.augmentation = args.cocokp_augmentation
        cls.rescale_images = args.cocokp_rescale_images
        cls.upsample_stride = args.cocokp_upsample
        cls.min_kp_anns = args.cocokp_min_kp_anns
        cls.bmin = args.cocokp_bmin

    def _encoders(self):
        encoders = [encoder.Cif(self.head_metas[0], bmin=self.bmin),
                    encoder.Caf(self.head_metas[1], bmin=self.bmin)]
        if len(self.head_metas) > 2:
            encoders.append(encoder.Caf(self.head_metas[2], bmin=self.bmin))
        return encoders

    def _preprocess(self):
        encoders = self._encoders()

        if not self.augmentation:
            return transforms.Compose([
                transforms.NormalizeAnnotations(),
                transforms.RescaleAbsolute(self.square_edge),
                transforms.CenterPad(self.square_edge),
                transforms.EVAL_TRANSFORM,
                transforms.Encoders(encoders),
            ])

        if self.extended_scale:
            rescale_t = transforms.RescaleRelative(
                scale_range=(0.25 * self.rescale_images,
                             2.0 * self.rescale_images),
                power_law=True, stretch_range=(0.75, 1.33))
        else:
            rescale_t = transforms.RescaleRelative(
                scale_range=(0.4 * self.rescale_images,
                             2.0 * self.rescale_images),
                power_law=True, stretch_range=(0.75, 1.33))

        from ...transforms.rotate import RotateBy90, RotateUniform
        return transforms.Compose([
            transforms.NormalizeAnnotations(),
            transforms.RandomApply(
                transforms.HFlip(COCO_KEYPOINTS, HFLIP), 0.5),
            rescale_t,
            transforms.RandomApply(transforms.Blur(), self.blur),
            transforms.RandomChoice(
                [RotateBy90(), RotateUniform(30.0)],
                [self.orientation_invariant, 0.4],
            ),
            transforms.Crop(self.square_edge, use_area_of_interest=True),
            transforms.CenterPad(self.square_edge),
            transforms.TRAIN_TRANSFORM,
            transforms.Encoders(encoders),
        ])

    def train_loader(self):
        train_data = CocoDataset(
            image_dir=self.train_image_dir,
            ann_file=self.train_annotations,
            preprocess=self._preprocess(),
            annotation_filter=True,
            min_kp_anns=self.min_kp_anns,
            category_ids=[1],
        )
        return Loader(
            train_data, batch_size=self.batch_size,
            shuffle=not self.debug and self.augmentation,
            num_workers=self.loader_workers, drop_last=True,
            collate_fn=collate.collate_images_targets_meta)

    def val_loader(self):
        val_data = CocoDataset(
            image_dir=self.val_image_dir,
            ann_file=self.val_annotations,
            preprocess=self._preprocess(),
            annotation_filter=True,
            min_kp_anns=self.min_kp_anns,
            category_ids=[1],
        )
        return Loader(
            val_data, batch_size=self.batch_size,
            shuffle=not self.debug and self.augmentation,
            num_workers=self.loader_workers, drop_last=True,
            collate_fn=collate.collate_images_targets_meta)
