"""Generic single-category keypoint data module (copy of
``openpifpaf_tpu/datasets/kp_module.py``).

The reference implements a near-identical CocoKp-style pipeline in every
keypoint plugin (crowdpose/module.py, wholebody/wholebody.py,
animalpose/animal_kp.py, apollocar3d/apollo_kp.py); here that pipeline is
factored once and parameterized with the dataset's constants: the head
metas (with per-edge CAF weights from the keypoint ``training_weights``),
the ``--<prefix>-*`` flags, the train, val and eval pipelines and
``metrics()``.
"""

import argparse

from .. import encoder, headmeta, metric, transforms
from ..configurable import Configurable
from .module import DataModule
from .collate import collate_images_anns_meta, collate_images_targets_meta
from .loader import Loader


class KpDataModule(DataModule, Configurable):
    """Subclass and set the class attributes below + the dataset constants."""

    debug = False

    # dataset identity (override)
    dataset_name = None
    cli_prefix = None

    keypoints = None
    sigmas = None
    skeleton = None
    dense_skeleton = None
    upright_pose = None
    hflip = None
    score_weights = None
    categories = ('person',)
    eval_category_id = 1

    train_annotations = None
    val_annotations = None
    eval_annotations = None
    train_image_dir = None
    val_image_dir = None
    eval_image_dir = None

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

    eval_annotation_filter = True
    eval_long_edge = 641
    eval_extended_scale = False
    eval_orientation_invariant = 0.0

    #: per-keypoint training weights (None = uniform)
    training_weights = None

    def __init__(self, **kwargs):
        super().__init__(**kwargs)

        # per-keypoint training weights (e.g. --wholebody/apollo-apply-
        # local-centrality-weights, reference wholebody.py:60-84): CAF
        # weights are the normalized per-edge max of the keypoint weights
        caf_weights = None
        if self.training_weights is not None:
            import numpy as np
            caf_w = np.array([
                max(self.training_weights[j1 - 1],
                    self.training_weights[j2 - 1])
                for j1, j2 in self.skeleton])
            caf_weights = list(caf_w / np.sum(caf_w) * len(caf_w))

        cif = headmeta.Cif('cif', self.dataset_name,
                           keypoints=self.keypoints,
                           sigmas=self.sigmas,
                           pose=self.upright_pose,
                           draw_skeleton=self.skeleton,
                           score_weights=self.score_weights,
                           training_weights=self.training_weights)
        caf = headmeta.Caf('caf', self.dataset_name,
                           keypoints=self.keypoints,
                           sigmas=self.sigmas,
                           pose=self.upright_pose,
                           skeleton=self.skeleton,
                           training_weights=caf_weights)
        self.head_metas = [cif, caf]
        if self.with_dense and self.dense_skeleton:
            dcaf = headmeta.Caf('caf25', self.dataset_name,
                                keypoints=self.keypoints,
                                sigmas=self.sigmas,
                                pose=self.upright_pose,
                                skeleton=self.dense_skeleton,
                                sparse_skeleton=self.skeleton,
                                only_in_field_of_view=True)
            self.head_metas.append(dcaf)
        for meta in self.head_metas:
            meta.upsample_stride = self.upsample_stride

    # -------------------------------------------------- CLI
    @classmethod
    def cli(cls, parser: argparse.ArgumentParser):
        p = cls.cli_prefix
        group = parser.add_argument_group(f'data module {cls.__name__}')
        group.add_argument(f'--{p}-train-annotations',
                           dest=f'{p}_train_annotations',
                           default=cls.train_annotations)
        group.add_argument(f'--{p}-val-annotations',
                           dest=f'{p}_val_annotations',
                           default=cls.val_annotations)
        group.add_argument(f'--{p}-train-image-dir',
                           dest=f'{p}_train_image_dir',
                           default=cls.train_image_dir)
        group.add_argument(f'--{p}-val-image-dir',
                           dest=f'{p}_val_image_dir',
                           default=cls.val_image_dir)
        group.add_argument(f'--{p}-square-edge', dest=f'{p}_square_edge',
                           default=cls.square_edge, type=int)
        group.add_argument(f'--{p}-upsample', dest=f'{p}_upsample',
                           default=cls.upsample_stride, type=int)
        group.add_argument(f'--{p}-orientation-invariant',
                           dest=f'{p}_orientation_invariant',
                           default=cls.orientation_invariant, type=float)
        group.add_argument(f'--{p}-extended-scale',
                           dest=f'{p}_extended_scale',
                           default=False, action='store_true')
        group.add_argument(f'--{p}-no-augmentation',
                           dest=f'{p}_augmentation',
                           default=True, action='store_false')
        group.add_argument(f'--{p}-rescale-images',
                           dest=f'{p}_rescale_images',
                           default=cls.rescale_images, type=float)
        group.add_argument(f'--{p}-min-kp-anns', dest=f'{p}_min_kp_anns',
                           default=cls.min_kp_anns, type=int)
        group.add_argument(f'--{p}-bmin', dest=f'{p}_bmin',
                           default=cls.bmin, type=float)
        group.add_argument(f'--{p}-eval-long-edge',
                           dest=f'{p}_eval_long_edge',
                           default=cls.eval_long_edge, type=int)
        group.add_argument(f'--{p}-blur', dest=f'{p}_blur',
                           default=cls.blur, type=float,
                           help='augment with blur')
        group.add_argument(f'--{p}-eval-extended-scale',
                           dest=f'{p}_eval_extended_scale',
                           default=False, action='store_true')
        group.add_argument(f'--{p}-eval-orientation-invariant',
                           dest=f'{p}_eval_orientation_invariant',
                           default=cls.eval_orientation_invariant,
                           type=float)
        group.add_argument(f'--{p}-no-eval-annotation-filter',
                           dest=f'{p}_eval_annotation_filter',
                           default=True, action='store_false')
        eval_set_group = group.add_mutually_exclusive_group()
        eval_set_group.add_argument(f'--{p}-eval-test2017',
                                    dest=f'{p}_eval_test2017',
                                    default=False, action='store_true')
        eval_set_group.add_argument(f'--{p}-eval-testdev2017',
                                    dest=f'{p}_eval_testdev2017',
                                    default=False, action='store_true')

    @classmethod
    def configure(cls, args: argparse.Namespace):
        p = cls.cli_prefix
        cls.debug = getattr(args, 'debug', False)
        cls.train_annotations = getattr(args, f'{p}_train_annotations')
        cls.val_annotations = getattr(args, f'{p}_val_annotations')
        cls.eval_annotations = cls.val_annotations
        cls.train_image_dir = getattr(args, f'{p}_train_image_dir')
        cls.val_image_dir = getattr(args, f'{p}_val_image_dir')
        cls.eval_image_dir = cls.val_image_dir
        cls.square_edge = getattr(args, f'{p}_square_edge')
        cls.upsample_stride = getattr(args, f'{p}_upsample')
        cls.orientation_invariant = getattr(args, f'{p}_orientation_invariant')
        cls.extended_scale = getattr(args, f'{p}_extended_scale')
        cls.augmentation = getattr(args, f'{p}_augmentation')
        cls.rescale_images = getattr(args, f'{p}_rescale_images')
        cls.min_kp_anns = getattr(args, f'{p}_min_kp_anns')
        cls.bmin = getattr(args, f'{p}_bmin')
        cls.eval_long_edge = getattr(args, f'{p}_eval_long_edge')
        cls.blur = getattr(args, f'{p}_blur')
        cls.eval_extended_scale = getattr(args, f'{p}_eval_extended_scale')
        cls.eval_orientation_invariant = getattr(
            args, f'{p}_eval_orientation_invariant')
        cls.eval_annotation_filter = getattr(
            args, f'{p}_eval_annotation_filter')
        if (getattr(args, f'{p}_eval_test2017')
                or getattr(args, f'{p}_eval_testdev2017')):
            # test sets have no public GT: predictions must be written
            # for server evaluation (reference animal_kp.py:165-168)
            test_annotations = getattr(cls, '_test2017_annotations', None)
            if getattr(args, f'{p}_eval_testdev2017'):
                test_annotations = getattr(
                    cls, '_testdev2017_annotations', test_annotations)
            if test_annotations:
                cls.eval_annotations = test_annotations
                cls.eval_image_dir = getattr(
                    cls, '_test2017_image_dir', cls.eval_image_dir)
            cls.eval_annotation_filter = False
            if not getattr(args, 'write_predictions', True) \
                    and not getattr(args, 'debug', False):
                raise RuntimeError(
                    'have to use --write-predictions for this dataset')

    # -------------------------------------------------- pipelines
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

        hflip_t = None
        if self.hflip:
            hflip_t = transforms.RandomApply(
                transforms.HFlip(self.keypoints, self.hflip), 0.5)

        return transforms.Compose([
            transforms.NormalizeAnnotations(),
            hflip_t,
            rescale_t,
            transforms.RandomApply(transforms.Blur(), self.blur),
            transforms.RandomChoice(
                [transforms.RotateBy90(), transforms.RotateUniform(30.0)],
                [self.orientation_invariant, 0.4]),
            transforms.Crop(self.square_edge, use_area_of_interest=True),
            transforms.CenterPad(self.square_edge),
            transforms.TRAIN_TRANSFORM,
            transforms.Encoders(encoders),
        ])

    def _dataset(self, image_dir, ann_file, preprocess, *,
                 annotation_filter=True, min_kp_anns=None):
        from ..plugins.coco.dataset import CocoDataset
        return CocoDataset(
            image_dir=image_dir,
            ann_file=ann_file,
            preprocess=preprocess,
            annotation_filter=annotation_filter,
            min_kp_anns=(min_kp_anns if min_kp_anns is not None
                         else self.min_kp_anns),
            category_ids=[self.eval_category_id],
        )

    def train_loader(self):
        data = self._dataset(self.train_image_dir, self.train_annotations,
                             self._preprocess())
        return Loader(
            data, batch_size=self.batch_size,
            shuffle=not self.debug and self.augmentation,
            num_workers=self.loader_workers, drop_last=True,
            collate_fn=collate_images_targets_meta)

    def val_loader(self):
        data = self._dataset(self.val_image_dir, self.val_annotations,
                             self._preprocess())
        return Loader(
            data, batch_size=self.batch_size, shuffle=False,
            num_workers=self.loader_workers, drop_last=True,
            collate_fn=collate_images_targets_meta)

    def _eval_preprocess(self):
        rescale_t = None
        if self.eval_extended_scale:
            assert self.eval_long_edge
            rescale_t = transforms.DeterministicEqualChoice([
                transforms.RescaleAbsolute(self.eval_long_edge),
                transforms.RescaleAbsolute(
                    (self.eval_long_edge - 1) // 2 + 1),
            ], salt=1)
        elif self.eval_long_edge:
            rescale_t = transforms.RescaleAbsolute(self.eval_long_edge)
        if self.batch_size == 1:
            padding_t = transforms.CenterPadTight(16)
        else:
            padding_t = transforms.CenterPad(self.eval_long_edge)

        orientation_t = None
        if self.eval_orientation_invariant:
            orientation_t = transforms.DeterministicEqualChoice([
                None,
                transforms.RotateBy90(fixed_angle=90),
                transforms.RotateBy90(fixed_angle=180),
                transforms.RotateBy90(fixed_angle=270),
            ], salt=3)

        return transforms.Compose([
            transforms.NormalizeAnnotations(),
            rescale_t,
            padding_t,
            orientation_t,
            transforms.ToAnnotations([
                transforms.ToKpAnnotations(
                    list(self.categories),
                    keypoints_by_category={
                        self.eval_category_id: self.head_metas[0].keypoints},
                    skeleton_by_category={
                        self.eval_category_id: self.head_metas[1].skeleton},
                ),
                transforms.ToCrowdAnnotations(list(self.categories)),
            ]),
            transforms.EVAL_TRANSFORM,
        ])

    def eval_loader(self):
        data = self._dataset(
            self.eval_image_dir, self.eval_annotations,
            self._eval_preprocess(),
            annotation_filter=self.eval_annotation_filter,
            min_kp_anns=(self.min_kp_anns
                         if self.eval_annotation_filter else 0))
        return Loader(
            data, batch_size=self.batch_size, shuffle=False,
            num_workers=self.loader_workers, drop_last=False,
            collate_fn=collate_images_anns_meta)

    def metrics(self):
        from ..plugins.coco.dataset import CocoIndex
        index = CocoIndex(self.eval_annotations)
        gt_by_image = {
            image_id: index.annotations(image_id, [self.eval_category_id])
            for image_id in index.images
        }
        return [metric.Coco(
            gt_by_image,
            max_per_image=20,
            category_ids=[self.eval_category_id],
            iou_type='keypoints',
            keypoint_oks_sigmas=self.sigmas,
        )]
