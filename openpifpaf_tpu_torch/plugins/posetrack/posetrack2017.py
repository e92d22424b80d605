"""Posetrack2017 eval-only data module (copy of
``openpifpaf_tpu/plugins/posetrack/posetrack2017.py``): the tracking head
metas of Posetrack2018, the old annolist annotation format, ground truth
evaluated outside (poseval)."""

import argparse

from ...datasets import DataModule, LoaderWithReset, collate
from ...datasets.loader import Loader
from .datasets import Posetrack2017 as Posetrack2017Dataset
from .posetrack2018 import Posetrack2018


class Posetrack2017(DataModule):
    train_annotations = 'data-posetrack2017/annotations/train/*.json'
    val_annotations = 'data-posetrack2017/annotations/val/*.json'
    eval_annotations = val_annotations
    data_root = 'data-posetrack2017'

    def __init__(self):
        super().__init__()
        # identical head metas to the 2018 module (reference
        # posetrack2017.py:30-72)
        self.head_metas = Posetrack2018().head_metas

    @classmethod
    def cli(cls, parser: argparse.ArgumentParser):
        group = parser.add_argument_group('data module Posetrack2017')
        group.add_argument('--posetrack2017-eval-annotations',
                           default=cls.eval_annotations,
                           help='eval annotations')
        group.add_argument('--posetrack2017-data-root',
                           default=cls.data_root,
                           help='data root')

    @classmethod
    def configure(cls, args: argparse.Namespace):
        cls.eval_annotations = args.posetrack2017_eval_annotations
        cls.data_root = args.posetrack2017_data_root

    def train_loader(self):
        raise NotImplementedError(
            'posetrack2017 is eval-only; train on posetrack2018')

    def val_loader(self):
        raise NotImplementedError(
            'posetrack2017 is eval-only; train on posetrack2018')

    def _eval_preprocess(self):
        # ToAnnotations is unnecessary: the 2017 reader yields no GT
        # (external poseval evaluation), so only geometry + normalization
        from ... import transforms
        return transforms.Compose([
            *Posetrack2018.common_eval_preprocess(),
            transforms.EVAL_TRANSFORM,
        ])

    def eval_loader(self):
        eval_data = Posetrack2017Dataset(
            self.eval_annotations, self.data_root,
            preprocess=self._eval_preprocess())
        loader = Loader(
            eval_data, batch_size=self.batch_size, shuffle=False,
            num_workers=self.loader_workers, drop_last=False,
            collate_fn=collate.collate_images_anns_meta)
        return LoaderWithReset(loader, 'annotation_file')

    def metrics(self):
        from .metric import Posetrack
        return [Posetrack(output_format='2017')]
