"""NuScenes plugin (copy of ``openpifpaf_tpu/plugins/nuscenes``): 2D
object detection with CifDet over 23 categories, COCO-format annotations,
and the published checkpoint name ``shufflenetv2k16-nuscenes``."""

import argparse

from ... import encoder, headmeta, metric, transforms
from ...datasets import DataModule, collate
from ...datasets.factory import DATAMODULES
from ...datasets.loader import Loader
from ..coco.dataset import CocoDataset, CocoIndex

NUSCENES_CATEGORIES = (
    'animal', 'human.pedestrian.adult', 'human.pedestrian.child',
    'human.pedestrian.construction_worker',
    'human.pedestrian.personal_mobility',
    'human.pedestrian.police_officer', 'human.pedestrian.stroller',
    'human.pedestrian.wheelchair', 'movable_object.barrier',
    'movable_object.debris', 'movable_object.pushable_pullable',
    'movable_object.trafficcone', 'static_object.bicycle_rack',
    'vehicle.bicycle', 'vehicle.bus.bendy', 'vehicle.bus.rigid',
    'vehicle.car', 'vehicle.construction', 'vehicle.emergency.ambulance',
    'vehicle.emergency.police', 'vehicle.motorcycle', 'vehicle.trailer',
    'vehicle.truck',
)


class NuScenes(DataModule):
    train_annotations = 'data-nuscenes/annotations/nuscenes_train.json'
    val_annotations = 'data-nuscenes/annotations/nuscenes_val.json'
    eval_annotations = val_annotations
    train_image_dir = 'data-nuscenes/'
    val_image_dir = 'data-nuscenes/'
    eval_image_dir = val_image_dir

    square_edge = 513
    upsample_stride = 1
    augmentation = True
    extended_scale = False
    orientation_invariant = 0.0
    blur = 0.0
    rescale_images = 1.0
    debug = False

    def __init__(self):
        super().__init__()
        cifdet = headmeta.CifDet('cifdet', 'nuscenes',
                                 categories=list(NUSCENES_CATEGORIES))
        cifdet.upsample_stride = self.upsample_stride
        self.head_metas = [cifdet]

    @classmethod
    def cli(cls, parser: argparse.ArgumentParser):
        group = parser.add_argument_group('data module NuScenes')
        group.add_argument('--nuscenes-train-annotations',
                           default=cls.train_annotations)
        group.add_argument('--nuscenes-val-annotations',
                           default=cls.val_annotations)
        group.add_argument('--nuscenes-train-image-dir',
                           default=cls.train_image_dir)
        group.add_argument('--nuscenes-val-image-dir',
                           default=cls.val_image_dir)
        group.add_argument('--nuscenes-square-edge',
                           default=cls.square_edge, type=int)
        group.add_argument('--nuscenes-upsample',
                           default=cls.upsample_stride, type=int)
        group.add_argument('--nuscenes-no-augmentation',
                           dest='nuscenes_augmentation',
                           default=True, action='store_false')
        group.add_argument('--nuscenes-extended-scale',
                           default=False, action='store_true')
        group.add_argument('--nuscenes-orientation-invariant',
                           default=cls.orientation_invariant, type=float)
        group.add_argument('--nuscenes-blur',
                           default=cls.blur, type=float)
        group.add_argument('--nuscenes-rescale-images',
                           default=cls.rescale_images, type=float)

    @classmethod
    def configure(cls, args: argparse.Namespace):
        cls.debug = getattr(args, 'debug', False)
        cls.train_annotations = args.nuscenes_train_annotations
        cls.val_annotations = args.nuscenes_val_annotations
        cls.eval_annotations = cls.val_annotations
        cls.train_image_dir = args.nuscenes_train_image_dir
        cls.val_image_dir = args.nuscenes_val_image_dir
        cls.eval_image_dir = cls.val_image_dir
        cls.square_edge = args.nuscenes_square_edge
        cls.upsample_stride = args.nuscenes_upsample
        cls.augmentation = args.nuscenes_augmentation
        cls.extended_scale = args.nuscenes_extended_scale
        cls.orientation_invariant = args.nuscenes_orientation_invariant
        cls.blur = args.nuscenes_blur
        cls.rescale_images = args.nuscenes_rescale_images

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
        scale_lo, scale_hi = ((0.5, 2.0) if self.extended_scale
                              else (0.7, 1.5))
        return transforms.Compose([
            transforms.NormalizeAnnotations(),
            transforms.RescaleRelative(
                scale_range=(scale_lo * self.rescale_images,
                             scale_hi * self.rescale_images),
                power_law=True, stretch_range=(0.75, 1.33)),
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
        data = CocoDataset(
            image_dir=self.train_image_dir,
            ann_file=self.train_annotations,
            preprocess=self._preprocess(),
            annotation_filter=True)
        return Loader(data, batch_size=self.batch_size,
                      shuffle=not self.debug,
                      num_workers=self.loader_workers, drop_last=True,
                      collate_fn=collate.collate_images_targets_meta)

    def val_loader(self):
        data = CocoDataset(
            image_dir=self.val_image_dir,
            ann_file=self.val_annotations,
            preprocess=self._preprocess(),
            annotation_filter=True)
        return Loader(data, batch_size=self.batch_size, shuffle=False,
                      num_workers=self.loader_workers, drop_last=True,
                      collate_fn=collate.collate_images_targets_meta)

    def _eval_preprocess(self):
        return transforms.Compose([
            transforms.NormalizeAnnotations(),
            transforms.RescaleAbsolute(641),
            transforms.CenterPadTight(16),
            transforms.ToAnnotations([
                transforms.ToDetAnnotations(list(NUSCENES_CATEGORIES)),
                transforms.ToCrowdAnnotations(list(NUSCENES_CATEGORIES)),
            ]),
            transforms.EVAL_TRANSFORM,
        ])

    def eval_loader(self):
        data = CocoDataset(
            image_dir=self.eval_image_dir,
            ann_file=self.eval_annotations,
            preprocess=self._eval_preprocess())
        return Loader(data, batch_size=self.batch_size, shuffle=False,
                      num_workers=self.loader_workers, drop_last=False,
                      collate_fn=collate.collate_images_anns_meta)

    def metrics(self):
        index = CocoIndex(self.eval_annotations)
        gt_by_image = {
            image_id: index.annotations(image_id)
            for image_id in index.images
        }
        return [metric.Coco(
            gt_by_image, max_per_image=100,
            category_ids=list(range(1, len(NUSCENES_CATEGORIES) + 1)),
            iou_type='bbox')]


def register():
    DATAMODULES['nuscenes'] = NuScenes
    _register_checkpoints()


def _register_checkpoints():
    from ...models import factory as models_factory
    models_factory.CHECKPOINT_URLS['shufflenetv2k16-nuscenes'] = (
        'http://github.com/DuncanZauss/openpifpaf_assets/releases/'
        'download/v0.1.0/nuscenes_sk16.pkl.epoch150')
