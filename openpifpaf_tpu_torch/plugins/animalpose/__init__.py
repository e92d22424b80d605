"""AnimalPose plugin: 20-keypoint animal pose over 5 species (copy of
``openpifpaf_tpu/plugins/animalpose`` with its published checkpoint
name)."""

import json
import os

import numpy as np

from ...datasets.factory import DATAMODULES
from ...datasets.kp_module import KpDataModule

with open(os.path.join(os.path.dirname(__file__), 'constants.json')) as _f:
    _C = json.load(_f)

ANIMAL_KEYPOINTS = _C['ANIMAL_KEYPOINTS']
ANIMAL_SKELETON = [tuple(e) for e in _C['ANIMAL_SKELETON']]
ANIMAL_SIGMAS = _C['ANIMAL_SIGMAS']
ANIMAL_POSE = np.asarray(_C['ANIMAL_POSE'])
HFLIP = _C['HFLIP']


class AnimalKp(KpDataModule):
    dataset_name = 'animal'
    cli_prefix = 'animal'

    keypoints = ANIMAL_KEYPOINTS
    sigmas = ANIMAL_SIGMAS
    skeleton = ANIMAL_SKELETON
    upright_pose = ANIMAL_POSE
    hflip = HFLIP

    train_annotations = 'data-animalpose/annotations/animal_keypoints_20_train.json'
    val_annotations = 'data-animalpose/annotations/animal_keypoints_20_val.json'
    eval_annotations = val_annotations
    train_image_dir = 'data-animalpose/images/train/'
    val_image_dir = 'data-animalpose/images/val/'
    eval_image_dir = val_image_dir

    square_edge = 513
    extended_scale = True
    orientation_invariant = 0.1


def register():
    DATAMODULES['animal'] = AnimalKp
    _register_checkpoints()


def _register_checkpoints():
    from ...models import factory as models_factory
    models_factory.CHECKPOINT_URLS['shufflenetv2k30-animalpose'] = (
        'http://github.com/vita-epfl/openpifpaf-torchhub/releases/'
        'download/v0.12.9/shufflenetv2k30-210511-120906-animal.pkl.epoch400')
