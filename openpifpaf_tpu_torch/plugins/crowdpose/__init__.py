"""CrowdPose plugin: 14-keypoint crowded-scene pose estimation (copy of
``openpifpaf_tpu/plugins/crowdpose`` with its published checkpoint
name)."""

import numpy as np

from ...datasets.factory import DATAMODULES
from ...datasets.kp_module import KpDataModule
from ..coco.constants import HFLIP as COCO_HFLIP

KEYPOINTS = [
    'left_shoulder',
    'right_shoulder',
    'left_elbow',
    'right_elbow',
    'left_wrist',
    'right_wrist',
    'left_hip',
    'right_hip',
    'left_knee',
    'right_knee',
    'left_ankle',
    'right_ankle',
    'head',
    'neck',
]

SKELETON = [
    (13, 14), (14, 1), (14, 2), (1, 2), (7, 8), (1, 3), (3, 5), (2, 4),
    (4, 6), (1, 7), (2, 8), (7, 9), (9, 11), (8, 10), (10, 12),
]

SIGMAS = [
    0.079, 0.079, 0.072, 0.072, 0.062, 0.062, 0.107, 0.107,
    0.087, 0.087, 0.089, 0.089, 0.079, 0.079,
]

UPRIGHT_POSE = np.array([
    [-1.4, 8.0, 2.0],   # left_shoulder
    [1.4, 8.0, 2.0],    # right_shoulder
    [-1.75, 6.0, 2.0],  # left_elbow
    [1.75, 6.2, 2.0],   # right_elbow
    [-1.75, 4.0, 2.0],  # left_wrist
    [1.75, 4.2, 2.0],   # right_wrist
    [-1.26, 4.0, 2.0],  # left_hip
    [1.26, 4.0, 2.0],   # right_hip
    [-1.4, 2.0, 2.0],   # left_knee
    [1.4, 2.1, 2.0],    # right_knee
    [-1.4, 0.0, 2.0],   # left_ankle
    [1.4, 0.1, 2.0],    # right_ankle
    [0.0, 10.3, 2.0],   # head
    [0.0, 9.3, 2.0],    # neck
])


class CrowdPose(KpDataModule):
    dataset_name = 'crowdpose'
    cli_prefix = 'crowdpose'

    keypoints = KEYPOINTS
    sigmas = SIGMAS
    skeleton = SKELETON
    upright_pose = UPRIGHT_POSE
    hflip = COCO_HFLIP

    train_annotations = 'data-crowdpose/json/crowdpose_trainval.json'
    val_annotations = 'data-crowdpose/json/crowdpose_val.json'
    eval_annotations = val_annotations
    train_image_dir = 'data-crowdpose/images/'
    val_image_dir = 'data-crowdpose/images/'
    eval_image_dir = val_image_dir
    _test_annotations = 'data-crowdpose/json/crowdpose_test.json'

    #: --crowdpose-index: easy/medium/hard crowdIndex subsets
    #: (reference crowdpose/module.py:344-349)
    eval_crowdpose_index = None

    @classmethod
    def cli(cls, parser):
        super().cli(parser)
        group = parser.add_argument_group('data module CrowdPose (eval)')
        group.add_argument('--crowdpose-image-dir', default=None,
                           help='single image dir for train/val/eval '
                                '(reference uses one directory)')
        group.add_argument('--crowdpose-eval-test', default=False,
                           action='store_true',
                           help='evaluate on the test set')
        group.add_argument('--crowdpose-index',
                           choices=('easy', 'medium', 'hard'), default=None)

    @classmethod
    def configure(cls, args):
        super().configure(args)
        if args.crowdpose_image_dir:
            cls.train_image_dir = args.crowdpose_image_dir
            cls.val_image_dir = args.crowdpose_image_dir
            cls.eval_image_dir = args.crowdpose_image_dir
        if args.crowdpose_eval_test:
            cls.eval_annotations = cls._test_annotations
            cls.eval_annotation_filter = False
        cls.eval_crowdpose_index = args.crowdpose_index

    def eval_loader(self):
        loader = super().eval_loader()
        if self.eval_crowdpose_index:
            # half-open buckets like the reference (min <= ci < max), except
            # the top bucket which includes its upper bound so crowdIndex 1.0
            # is evaluated exactly once
            lo, hi = {'easy': (0.0, 0.1), 'medium': (0.1, 0.8),
                      'hard': (0.8, 1.0)}[self.eval_crowdpose_index]
            top = self.eval_crowdpose_index == 'hard'
            data = loader.dataset

            def _in_bucket(ci):
                return lo <= ci < hi or (top and ci == hi)

            data.ids = [
                image_id for image_id in data.ids
                if _in_bucket(
                    data.coco.images[image_id].get('crowdIndex', 0.0))]
        return loader


def register():
    DATAMODULES['crowdpose'] = CrowdPose
    _register_checkpoints()


def _register_checkpoints():
    from ...models import factory as models_factory
    models_factory.CHECKPOINT_URLS['resnet50-crowdpose'] = (
        'http://github.com/vita-epfl/openpifpaf-torchhub/releases/'
        'download/v0.12a7/resnet50-201005-100758-crowdpose-d978a89f.pkl')
