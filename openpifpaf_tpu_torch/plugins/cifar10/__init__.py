"""CIFAR-10 plugin (copy of ``openpifpaf_tpu/plugins/cifar10``): the
smallest end-to-end CifDet example. ``Cifar10Net`` is a small stride-16
convnet (four 3x3 stride-2 convs with bias and ReLU, 128 features) that
``register()`` adds to the backbones as ``cifar10net``; the data module
reads the standard CIFAR-10 python batches directly (no torchvision)."""

import argparse
import os
import pickle

import numpy as np
import PIL.Image
from torch import nn
import torch.nn.functional as F

from ... import encoder, headmeta, transforms
from ...datasets import DataModule, collate
from ...datasets.factory import DATAMODULES
from ...datasets.loader import Loader
from ...models.factory import BASE_FACTORIES

CATEGORIES = ('plane', 'car', 'bird', 'cat', 'deer', 'dog', 'frog',
              'horse', 'ship', 'truck')


class Cifar10Net(nn.Module):
    """Small stride-16 convnet (the JAX package's ``Cifar10Net``): flax's
    ``Conv_i`` is ``convs.i``."""

    stride = 16
    out_features = 128

    def __init__(self):
        super().__init__()
        self.convs = nn.ModuleList(
            nn.Conv2d(c_in, c_out, 3, stride=2, padding=1)
            for c_in, c_out in ((3, 16), (16, 32), (32, 64), (64, 128)))

    def forward(self, x, train=False, remat=False):
        """``train`` and ``remat`` are the backbones' interface; the net
        has no norm and nothing to recompute."""
        for conv in self.convs:
            x = F.relu(conv(x))
        return x


class Cifar10Dataset:
    """CIFAR-10 python-batch reader."""

    def __init__(self, root_dir, *, train=True, preprocess=None):
        batch_files = ([f'data_batch_{i}' for i in range(1, 6)]
                       if train else ['test_batch'])
        base = os.path.join(root_dir, 'cifar-10-batches-py')
        images, labels = [], []
        for name in batch_files:
            path = os.path.join(base, name)
            if not os.path.exists(path):
                continue
            with open(path, 'rb') as f:
                batch = pickle.load(f, encoding='bytes')
            images.append(np.asarray(batch[b'data']).reshape(-1, 3, 32, 32))
            labels.extend(batch[b'labels'])
        self.images = (np.concatenate(images).transpose(0, 2, 3, 1)
                       if images else np.zeros((0, 32, 32, 3), dtype=np.uint8))
        self.labels = labels
        self.preprocess = preprocess

    def __getitem__(self, index):
        image = PIL.Image.fromarray(self.images[index].astype(np.uint8))
        anns = [{
            'bbox': np.asarray([5, 5, 21, 21], dtype=np.float32),
            'category_id': int(self.labels[index]) + 1,
            'iscrowd': False,
        }]
        meta = {'dataset_index': index, 'image_id': index}
        if self.preprocess is not None:
            image, anns, meta = self.preprocess(image, anns, meta)
        return image, anns, meta

    def __len__(self):
        return len(self.labels)


class Cifar10(DataModule):
    root_dir = 'data-cifar10/'
    debug = False

    def __init__(self):
        super().__init__()
        cifdet = headmeta.CifDet('cifdet', 'cifar10',
                                 categories=list(CATEGORIES))
        self.head_metas = [cifdet]

    @classmethod
    def cli(cls, parser: argparse.ArgumentParser):
        group = parser.add_argument_group('data module Cifar10')
        group.add_argument('--cifar10-root-dir', default=cls.root_dir)
        group.add_argument('--cifar10-download', default=False,
                           action='store_true',
                           help='download CIFAR-10 python batches into '
                                'the root dir if missing')

    @classmethod
    def configure(cls, args: argparse.Namespace):
        cls.debug = getattr(args, 'debug', False)
        cls.root_dir = args.cifar10_root_dir
        if args.cifar10_download:
            cls.download(cls.root_dir)

    @staticmethod
    def download(root_dir):
        """Fetch and unpack cifar-10-python.tar.gz if not present."""
        import os
        import tarfile
        import urllib.request

        if os.path.isdir(os.path.join(root_dir, 'cifar-10-batches-py')):
            return
        os.makedirs(root_dir, exist_ok=True)
        url = 'https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz'
        tar_path = os.path.join(root_dir, 'cifar-10-python.tar.gz')
        urllib.request.urlretrieve(url, tar_path)
        with tarfile.open(tar_path, 'r:gz') as tar:
            # filter='data' blocks path traversal from a tampered archive
            tar.extractall(root_dir, filter='data')

    def _preprocess(self):
        enc = encoder.CifDet(self.head_metas[0])
        return transforms.Compose([
            transforms.NormalizeAnnotations(),
            transforms.EVAL_TRANSFORM,
            transforms.Encoders([enc]),
        ])

    def train_loader(self):
        data = Cifar10Dataset(self.root_dir, train=True,
                              preprocess=self._preprocess())
        return Loader(data, batch_size=self.batch_size,
                      shuffle=not self.debug,
                      num_workers=self.loader_workers, drop_last=True,
                      collate_fn=collate.collate_images_targets_meta)

    def val_loader(self):
        data = Cifar10Dataset(self.root_dir, train=False,
                              preprocess=self._preprocess())
        return Loader(data, batch_size=self.batch_size, shuffle=False,
                      num_workers=self.loader_workers, drop_last=True,
                      collate_fn=collate.collate_images_targets_meta)

    def _eval_preprocess(self):
        return transforms.Compose([
            transforms.NormalizeAnnotations(),
            transforms.ToAnnotations([
                transforms.ToDetAnnotations(list(CATEGORIES)),
            ]),
            transforms.EVAL_TRANSFORM,
        ])

    def eval_loader(self):
        data = Cifar10Dataset(self.root_dir, train=False,
                              preprocess=self._eval_preprocess())
        return Loader(data, batch_size=self.batch_size, shuffle=False,
                      num_workers=self.loader_workers, drop_last=False,
                      collate_fn=collate.collate_images_anns_meta)

    def metrics(self):
        from ...metric.classification import Classification
        return [Classification(categories=list(CATEGORIES))]


def register():
    DATAMODULES['cifar10'] = Cifar10
    BASE_FACTORIES['cifar10net'] = Cifar10Net
