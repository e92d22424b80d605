"""High-level Predictor API (port of ``openpifpaf_tpu/predictor.py``).

Model -> forward -> CifCaf decode, with generators over image files,
numpy arrays and datasets. The serving loop is strict: each batch is
forwarded, decoded and yielded before the next one starts.
"""

import logging
import time

import numpy as np
import torch

from . import decoder, transforms
from .models.factory import Factory
from .plugins.coco.constants import cocokp_head_metas

LOG = logging.getLogger(__name__)


def _collate(items):
    """(images (B, H, W, 3) float32 padded to the batch maximum, anns,
    metas) from (image, anns, meta) samples."""
    images = [np.asarray(item[0]) for item in items]
    hmax = max(im.shape[0] for im in images)
    wmax = max(im.shape[1] for im in images)
    batch = np.zeros((len(images), hmax, wmax, images[0].shape[2]),
                     dtype=np.float32)
    for i, im in enumerate(images):
        batch[i, :im.shape[0], :im.shape[1]] = im
    return batch, [item[1] for item in items], [item[2] for item in items]


class _Images:
    """Sequence of preprocessed samples from loaded images."""

    def __init__(self, sources, load, preprocess, meta):
        self.sources = sources
        self.load = load
        self.preprocess = preprocess
        self.meta = meta

    def __len__(self):
        return len(self.sources)

    def __getitem__(self, index):
        image = self.load(self.sources[index])
        return self.preprocess(image, [], self.meta(index))


def _load_rgb(file_name):
    import PIL.Image
    with open(file_name, 'rb') as f:
        return np.asarray(PIL.Image.open(f).convert('RGB'))


class Predictor:
    batch_size = 1
    long_edge = None
    #: pad images up to the next multiple of this many pixels plus one,
    #: as the JAX Predictor does (it bounds the number of shapes)
    size_bucket = 128

    def __init__(self, checkpoint=None, head_metas=None, *, model=None,
                 device=None, json_data=False):
        """Without ``model``: a ``shufflenetv2k16`` with ``head_metas``
        (default: the cocokp heads), randomly initialised from seed 0.
        ``device`` defaults to the first CUDA device if there is one."""
        if checkpoint is not None:
            raise NotImplementedError(
                'loading a checkpoint is not yet ported to PyTorch '
                '(ROADMAP A11: training/checkpoint.py)')
        if model is None:
            LOG.warning('no checkpoint given: using randomly initialized '
                        'cocokp model')
            model = Factory().from_scratch(
                head_metas or cocokp_head_metas(),
                generator=torch.Generator().manual_seed(0))
        if device is None:
            device = 'cuda' if torch.cuda.is_available() else 'cpu'
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.head_metas = model.head_metas
        self.processor = decoder.factory(self.head_metas)
        self.json_data = json_data

        self.preprocess = self._build_preprocess()
        self.last_decoder_time = 0.0
        self.last_nn_time = 0.0
        self.total_nn_time = 0.0
        self.total_decoder_time = 0.0
        self.total_images = 0

    def _build_preprocess(self, long_edge=None):
        if long_edge is None:
            long_edge = self.long_edge
        return transforms.Compose([
            transforms.NormalizeAnnotations(),
            transforms.RescaleAbsolute(long_edge) if long_edge else None,
            transforms.CenterPadTight(16),
            transforms.EVAL_TRANSFORM,
        ])

    def _bucket_pad(self, image_batch):
        """Zero-pad (B, H, W, 3) to bucketed H/W (multiple of bucket + 1).

        Padding after normalisation only adds field cells outside the
        original image; annotations are inverse-transformed with the
        original meta.
        """
        if not self.size_bucket:
            return image_batch
        b = self.size_bucket
        h, w = image_batch.shape[1:3]
        target_h = ((max(h - 1, 1) + b - 1) // b) * b + 1
        target_w = ((max(w - 1, 1) + b - 1) // b) * b + 1
        if (target_h, target_w) == (h, w):
            return image_batch
        out = np.zeros((image_batch.shape[0], target_h, target_w,
                        image_batch.shape[3]), dtype=image_batch.dtype)
        out[:, :h, :w] = image_batch
        return out

    def fields_batch(self, image_batch):
        """Per-head (B, F, C, H, W) fields of a (B, H, W, 3) float batch,
        on ``self.device``."""
        start = time.perf_counter()
        image_batch = self._bucket_pad(np.asarray(image_batch,
                                                  dtype=np.float32))
        images = torch.from_numpy(image_batch).to(self.device)
        with torch.inference_mode():
            fields = self.model(images)
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        self.last_nn_time = time.perf_counter() - start
        return list(fields)

    def _run_batch(self, image_batch, gt_anns_batch, meta_batch):
        fields = self.fields_batch(image_batch)
        pred_batch = self.processor.batch_decode(fields)
        self.last_decoder_time = self.processor.last_decoder_time
        self.total_nn_time += self.last_nn_time
        self.total_decoder_time += self.last_decoder_time
        self.total_images += len(meta_batch)

        for pred, gt_anns, meta in zip(pred_batch, gt_anns_batch, meta_batch):
            pred = [ann.inverse_transform(meta) for ann in pred]
            if self.json_data:
                pred = [ann.json_data() for ann in pred]
            yield pred, gt_anns, meta

    def dataset(self, data):
        """Iterate a dataset of (image, anns, meta) samples in batches of
        ``batch_size``; yields (predictions, gt_anns, meta) per image."""
        for start in range(0, len(data), self.batch_size):
            items = [data[i] for i in
                     range(start, min(start + self.batch_size, len(data)))]
            yield from self._run_batch(*_collate(items))

    def images(self, file_names):
        file_names = list(file_names)
        data = _Images(
            file_names, _load_rgb, self.preprocess,
            lambda i: {'dataset_index': i, 'file_name': file_names[i]})
        yield from self.dataset(data)

    def numpy_images(self, numpy_images):
        """Images as (H, W, 3) uint8 arrays."""
        numpy_images = list(numpy_images)
        data = _Images(numpy_images, np.asarray, self.preprocess,
                       lambda i: {'dataset_index': i})
        yield from self.dataset(data)

    def image(self, file_name):
        return next(iter(self.images([file_name])))

    def numpy_image(self, image):
        return next(iter(self.numpy_images([image])))
