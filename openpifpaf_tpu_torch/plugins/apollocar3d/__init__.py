"""ApolloCar3D plugin: 24- or 66-keypoint car pose estimation (copy of
``openpifpaf_tpu/plugins/apollocar3d`` with its published checkpoint
names)."""

import json
import os

import numpy as np

from ...datasets.factory import DATAMODULES
from ...datasets.kp_module import KpDataModule

with open(os.path.join(os.path.dirname(__file__), 'constants.json')) as _f:
    _C = json.load(_f)

CAR_KEYPOINTS_24 = _C['CAR_KEYPOINTS_24']
CAR_SKELETON_24 = [tuple(e) for e in _C['CAR_SKELETON_24']]
CAR_SIGMAS_24 = _C['CAR_SIGMAS_24']
CAR_POSE_24 = np.asarray(_C['CAR_POSE_24'])
HFLIP_24 = _C['HFLIP_24']

CAR_KEYPOINTS_66 = _C['CAR_KEYPOINTS_66']
CAR_SKELETON_66 = [tuple(e) for e in _C['CAR_SKELETON_66']]
CAR_SIGMAS_66 = _C['CAR_SIGMAS_66']
CAR_POSE_66 = np.asarray(_C['CAR_POSE_66'])
HFLIP_66 = _C['HFLIP_66']


class ApolloKp(KpDataModule):
    dataset_name = 'apollo'
    cli_prefix = 'apollo'

    use_24_kps = True

    keypoints = CAR_KEYPOINTS_24
    sigmas = CAR_SIGMAS_24
    skeleton = CAR_SKELETON_24
    upright_pose = CAR_POSE_24
    hflip = HFLIP_24
    categories = ('car',)

    train_annotations = 'data-apollocar3d/annotations/apollo_keypoints_24_train.json'
    val_annotations = 'data-apollocar3d/annotations/apollo_keypoints_24_val.json'
    eval_annotations = val_annotations
    train_image_dir = 'data-apollocar3d/images/train/'
    val_image_dir = 'data-apollocar3d/images/val/'
    eval_image_dir = val_image_dir

    square_edge = 513
    extended_scale = True

    @classmethod
    def cli(cls, parser):
        super().cli(parser)
        group = parser.add_argument_group('data module Apollo (kp count)')
        group.add_argument('--apollo-use-24-kps', default=False,
                           action='store_true',
                           help='24-keypoint car configuration '
                                '(the default here; reference flag kept '
                                'for compatibility)')
        group.add_argument('--apollo-use-66-kps', default=False,
                           action='store_true',
                           help='66-keypoint car configuration')
        group.add_argument('--apollo-apply-local-centrality-weights',
                           dest='apollo_apply_local_centrality',
                           default=False, action='store_true',
                           help='per-keypoint local-centrality training '
                                'weights (66-kp configuration only)')

    @classmethod
    def configure(cls, args):
        if getattr(args, 'apollo_use_66_kps', False):
            cls.use_66()
        if getattr(args, 'apollo_apply_local_centrality', False):
            if cls.use_24_kps:
                raise ValueError('local centrality weights only work '
                                 'with 66 kps (reference '
                                 'apollo_kp.py:203-204)')
            cls.training_weights = _C['TRAINING_WEIGHTS_LOCAL_CENTRALITY']
        super().configure(args)

    def metrics(self):
        from .metrics import MeanPixelError
        return super().metrics() + [MeanPixelError()]

    @classmethod
    def use_66(cls):
        """Switch the module to the 66-keypoint configuration."""
        cls.use_24_kps = False
        cls.keypoints = CAR_KEYPOINTS_66
        cls.sigmas = CAR_SIGMAS_66
        cls.skeleton = CAR_SKELETON_66
        cls.upright_pose = CAR_POSE_66
        cls.hflip = HFLIP_66
        cls.train_annotations = \
            'data-apollocar3d/annotations/apollo_keypoints_66_train.json'
        cls.val_annotations = \
            'data-apollocar3d/annotations/apollo_keypoints_66_val.json'
        cls.eval_annotations = cls.val_annotations


def register():
    DATAMODULES['apollo'] = ApolloKp
    _register_checkpoints()


def _register_checkpoints():
    from ...models import factory as models_factory
    models_factory.CHECKPOINT_URLS['shufflenetv2k16-apollo-24'] = (
        'http://github.com/DuncanZauss/openpifpaf_assets/releases/'
        'download/v0.1.0/shufflenetv2k16-201113-135121-apollo.pkl.epoch290')
    models_factory.CHECKPOINT_URLS['shufflenetv2k16-apollo-66'] = (
        'http://github.com/DuncanZauss/openpifpaf_assets/releases/'
        'download/v0.1.0/sk16_apollo_66kp.pkl')
    models_factory.CHECKPOINT_URLS['shufflenetv2k30-apollo-66'] = (
        'http://github.com/DuncanZauss/openpifpaf_assets/releases/'
        'download/v0.1.0/sk30_apollo_66kp.pkl')
