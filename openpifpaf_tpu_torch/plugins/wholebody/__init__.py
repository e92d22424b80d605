"""WholeBody plugin: COCO WholeBody 133-keypoint pose estimation
(body + feet + face + hands); copy of ``openpifpaf_tpu/plugins/wholebody``
with its published checkpoint names.

Dataset constants (keypoint names, skeleton, sigmas, canonical pose) are
stored in ``constants.json`` (public COCO-WholeBody dataset definitions).
"""

import json
import os

import numpy as np

from ...datasets.factory import DATAMODULES
from ...datasets.kp_module import KpDataModule

with open(os.path.join(os.path.dirname(__file__), 'constants.json')) as _f:
    _C = json.load(_f)

WHOLEBODY_KEYPOINTS = _C['WHOLEBODY_KEYPOINTS']
WHOLEBODY_SKELETON = [tuple(e) for e in _C['WHOLEBODY_SKELETON']]
WHOLEBODY_SIGMAS = _C['WHOLEBODY_SIGMAS']
WHOLEBODY_SCORE_WEIGHTS = _C['WHOLEBODY_SCORE_WEIGHTS']
WHOLEBODY_STANDING_POSE = np.asarray(_C['WHOLEBODY_STANDING_POSE'])
HFLIP = _C['HFLIP']


class Wholebody(KpDataModule):
    dataset_name = 'wholebody'
    cli_prefix = 'wholebody'

    keypoints = WHOLEBODY_KEYPOINTS
    sigmas = WHOLEBODY_SIGMAS
    skeleton = WHOLEBODY_SKELETON
    upright_pose = WHOLEBODY_STANDING_POSE
    hflip = HFLIP
    score_weights = WHOLEBODY_SCORE_WEIGHTS

    train_annotations = ('data-mscoco/annotations/'
                         'person_keypoints_train2017_wholebody_pifpaf_style.json')
    val_annotations = ('data-mscoco/annotations/'
                       'coco_wholebody_val_v1.0.json')
    eval_annotations = val_annotations
    train_image_dir = 'data-mscoco/images/train2017/'
    val_image_dir = 'data-mscoco/images/val2017/'
    eval_image_dir = val_image_dir

    @classmethod
    def cli(cls, parser):
        super().cli(parser)
        group = parser.add_argument_group('data module wholebody (weights)')
        group.add_argument('--wholebody-apply-local-centrality-weights',
                           dest='wholebody_apply_local_centrality',
                           default=False, action='store_true',
                           help='per-keypoint local-centrality training '
                                'weights')

    @classmethod
    def configure(cls, args):
        super().configure(args)
        if args.wholebody_apply_local_centrality:
            cls.training_weights = _C[
                'TRAINING_WEIGHTS_LOCAL_CENTRALITY']

    def metrics(self):
        from ..coco.dataset import CocoIndex
        from .metric import WholeBodyMetric
        index = CocoIndex(self.eval_annotations)
        gt_by_image = {
            image_id: index.annotations(image_id, [1])
            for image_id in index.images
        }
        return [WholeBodyMetric(gt_by_image, sigmas=self.sigmas)]


def register():
    DATAMODULES['wholebody'] = Wholebody
    _register_checkpoints()


def _register_checkpoints():
    from ...models import factory as models_factory
    models_factory.CHECKPOINT_URLS['shufflenetv2k16-wholebody'] = (
        'http://github.com/DuncanZauss/openpifpaf_assets/releases/'
        'download/v0.1.0/sk16_wholebody.pkl')
    models_factory.CHECKPOINT_URLS['shufflenetv2k30-wholebody'] = (
        'http://github.com/DuncanZauss/openpifpaf_assets/releases/'
        'download/v0.1.0/sk30_wholebody.pkl')
