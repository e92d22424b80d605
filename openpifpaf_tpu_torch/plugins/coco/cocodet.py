"""CocoDet data module (copy of ``openpifpaf_tpu/plugins/coco/cocodet.py``:
the 80-category CifDet head, the train, val and eval loaders, the bbox
metric and every flag)."""

import argparse

from ... import encoder, headmeta, metric, transforms
from ...configurable import Configurable
from ...datasets import DataModule, collate
from ...datasets.loader import Loader
from .dataset import CocoDataset, CocoIndex
from .constants import COCO_CATEGORIES


class CocoDet(DataModule, Configurable):
    debug = False

    train_annotations = 'data-mscoco/annotations/instances_train2017.json'
    val_annotations = 'data-mscoco/annotations/instances_val2017.json'
    eval_annotations = val_annotations
    train_image_dir = 'data-mscoco/images/train2017/'
    val_image_dir = 'data-mscoco/images/val2017/'
    eval_image_dir = val_image_dir

    square_edge = 513
    extended_scale = False
    orientation_invariant = 0.0
    blur = 0.0
    augmentation = True
    rescale_images = 1.0
    upsample_stride = 1

    eval_annotation_filter = True
    eval_long_edge = 641

    def __init__(self, **kwargs):
        super().__init__(**kwargs)

        cifdet = headmeta.CifDet('cifdet', 'cocodet',
                                 categories=COCO_CATEGORIES)
        cifdet.upsample_stride = self.upsample_stride
        self.head_metas = [cifdet]

    @classmethod
    def cli(cls, parser: argparse.ArgumentParser):
        group = parser.add_argument_group('data module CocoDet')
        group.add_argument('--cocodet-train-annotations',
                           default=cls.train_annotations)
        group.add_argument('--cocodet-val-annotations',
                           default=cls.val_annotations)
        group.add_argument('--cocodet-train-image-dir',
                           default=cls.train_image_dir)
        group.add_argument('--cocodet-val-image-dir',
                           default=cls.val_image_dir)
        group.add_argument('--cocodet-square-edge',
                           default=cls.square_edge, type=int)
        group.add_argument('--cocodet-no-augmentation',
                           dest='cocodet_augmentation',
                           default=True, action='store_false')
        group.add_argument('--cocodet-upsample',
                           default=cls.upsample_stride, type=int)
        group.add_argument('--cocodet-extended-scale',
                           default=False, action='store_true')
        group.add_argument('--cocodet-orientation-invariant',
                           default=cls.orientation_invariant, type=float)
        group.add_argument('--cocodet-blur',
                           default=cls.blur, type=float)
        group.add_argument('--cocodet-rescale-images',
                           default=cls.rescale_images, type=float)

    @classmethod
    def configure(cls, args: argparse.Namespace):
        cls.debug = getattr(args, 'debug', False)
        cls.train_annotations = args.cocodet_train_annotations
        cls.val_annotations = args.cocodet_val_annotations
        cls.eval_annotations = cls.val_annotations
        cls.train_image_dir = args.cocodet_train_image_dir
        cls.val_image_dir = args.cocodet_val_image_dir
        cls.eval_image_dir = cls.val_image_dir
        cls.square_edge = args.cocodet_square_edge
        cls.augmentation = args.cocodet_augmentation
        cls.upsample_stride = args.cocodet_upsample
        cls.extended_scale = args.cocodet_extended_scale
        cls.orientation_invariant = args.cocodet_orientation_invariant
        cls.blur = args.cocodet_blur
        cls.rescale_images = args.cocodet_rescale_images

    def _preprocess(self):
        enc = encoder.CifDet(self.head_metas[0])

        if not self.augmentation:
            return transforms.Compose([
                transforms.NormalizeAnnotations(),
                transforms.RescaleAbsolute(self.square_edge),
                transforms.CenterPad(self.square_edge),
                transforms.EVAL_TRANSFORM,
                transforms.Encoders([enc]),
            ])

        # reference cocodet.py: extended scale widens the sampling range
        if self.extended_scale:
            rescale_t = transforms.RescaleRelative(
                scale_range=(0.5 * self.rescale_images,
                             2.0 * self.rescale_images),
                power_law=True, stretch_range=(0.75, 1.33))
        else:
            rescale_t = transforms.RescaleRelative(
                scale_range=(0.7 * self.rescale_images,
                             1.5 * self.rescale_images),
                power_law=True, stretch_range=(0.75, 1.33))

        from .constants import COCO_KEYPOINTS, HFLIP
        return transforms.Compose([
            transforms.NormalizeAnnotations(),
            transforms.RandomApply(
                transforms.HFlip(COCO_KEYPOINTS, HFLIP), 0.5),
            rescale_t,
            transforms.RandomApply(transforms.Blur(), self.blur),
            transforms.RandomChoice(
                [transforms.RotateBy90(),
                 transforms.RotateUniform(10.0)],
                [self.orientation_invariant, 0.2],
            ),
            transforms.Crop(self.square_edge, use_area_of_interest=True),
            transforms.CenterPad(self.square_edge),
            transforms.MinSize(min_side=4.0),
            transforms.UnclippedArea(threshold=0.75),
            transforms.TRAIN_TRANSFORM,
            transforms.Encoders([enc]),
        ])

    def train_loader(self):
        train_data = CocoDataset(
            image_dir=self.train_image_dir,
            ann_file=self.train_annotations,
            preprocess=self._preprocess(),
            annotation_filter=True,
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
        )
        return Loader(
            val_data, batch_size=self.batch_size,
            shuffle=not self.debug and self.augmentation,
            num_workers=self.loader_workers, drop_last=True,
            collate_fn=collate.collate_images_targets_meta)

    def _eval_preprocess(self):
        rescale_t = None
        if self.eval_long_edge:
            rescale_t = transforms.RescaleAbsolute(self.eval_long_edge)
        if self.batch_size == 1:
            padding_t = transforms.CenterPadTight(16)
        else:
            padding_t = transforms.CenterPad(self.eval_long_edge)

        return transforms.Compose([
            transforms.NormalizeAnnotations(),
            rescale_t,
            padding_t,
            transforms.ToAnnotations([
                transforms.ToDetAnnotations(COCO_CATEGORIES),
                transforms.ToCrowdAnnotations(COCO_CATEGORIES),
            ]),
            transforms.EVAL_TRANSFORM,
        ])

    def eval_loader(self):
        eval_data = CocoDataset(
            image_dir=self.eval_image_dir,
            ann_file=self.eval_annotations,
            preprocess=self._eval_preprocess(),
            annotation_filter=self.eval_annotation_filter,
        )
        return Loader(
            eval_data, batch_size=self.batch_size, shuffle=False,
            num_workers=self.loader_workers, drop_last=False,
            collate_fn=collate.collate_images_anns_meta)

    def metrics(self):
        index = CocoIndex(self.eval_annotations)
        gt_by_image = {
            image_id: index.annotations(image_id)
            for image_id in index.images
        }
        return [metric.Coco(
            gt_by_image,
            max_per_image=100,
            category_ids=list(range(1, 81)),
            iou_type='bbox',
        )]
