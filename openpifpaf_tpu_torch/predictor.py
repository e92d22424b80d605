"""High-level Predictor API (port of ``openpifpaf_tpu/predictor.py``).

Model -> forward -> decode (the decoder factory's ``Multi``), with
generators over image files, numpy arrays and datasets; a tracking model's
forward caches the previous frame's features. The serving loop is strict:
each batch is forwarded, decoded and yielded before the next one starts.
"""

import copy
import logging
import time

import numpy as np
import torch

from . import decoder, transforms
from .datasets.collate import collate_images_anns_meta
from .models import factory as models_factory
from .models import fused_inference
from .models.basenetworks import ShuffleNetV2K
from .models.tracking import TrackingShell
from .plugins.coco.constants import cocokp_head_metas
from .signal_ import Signal
from .training import checkpoint as ckpt_mod

LOG = logging.getLogger(__name__)


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
        return PIL.Image.open(f).convert('RGB')


def _pil_image(image):
    """The transforms take PIL images; (H, W, 3) uint8 arrays convert."""
    import PIL.Image
    if isinstance(image, PIL.Image.Image):
        return image
    return PIL.Image.fromarray(np.asarray(image))


#: ``--backbone-engine`` choices, as the JAX package has them
BACKBONE_ENGINES = ('auto', 'flax', 'folded', 'halves', 'pallas', 'stencil',
                    'dwpallas')


class Predictor:
    batch_size = 1
    long_edge = None
    #: pad images up to the next multiple of this many pixels plus one,
    #: as the JAX Predictor does (it bounds the number of shapes)
    size_bucket = 128

    def __init__(self, checkpoint=None, head_metas=None, *, model=None,
                 device=None, json_data=False, backbone_engine='auto',
                 bf16=False):
        """Without ``model``: the checkpoint of the port's trainer at
        ``checkpoint`` (with ``head_metas``, consolidated as
        ``--head-consolidation`` says), else a ``shufflenetv2k16`` with
        ``head_metas`` (default: the cocokp heads), randomly initialised
        from seed 0.
        ``device`` defaults to the first CUDA device; without one it
        raises, and the CPU is run only when asked for (``device='cpu'``).

        ``backbone_engine`` (:data:`BACKBONE_ENGINES`) picks the serving
        backbone: ``'flax'`` the module graph, ``'folded'`` (and its
        aliases ``'halves'``, ``'stencil'``) the BN-folded convs,
        ``'dwpallas'`` the folded convs with the depthwise kernel,
        ``'pallas'`` the folded convs with the fused-block kernel; ``'auto'``
        takes ``'halves'`` for a BatchNorm ShuffleNetV2K whose every
        stage's channel halves are multiples of 128, the module graph
        otherwise (k16's 174, a ResNet, a group norm). ``bf16`` runs the
        backbone in bfloat16 (weights cast once) and the heads in float32.

        A tracking model (a ``TrackingShell``) serves one frame per batch
        on the module graph in float32, as JAX's does: the backbone runs on
        the new frame only, its features stay on the device for the next
        frame, and the heads run on the pair [new, previous]. The cache is
        dropped on a resolution change and on the ``eval_reset`` signal.
        An explicit engine or ``bf16`` raises ``ValueError`` for it.
        """
        if backbone_engine not in BACKBONE_ENGINES:
            raise ValueError(f'unknown backbone engine {backbone_engine!r}; '
                             f'one of {BACKBONE_ENGINES}')
        if model is None and checkpoint is not None:
            model, _ = ckpt_mod.load_shell(
                checkpoint, head_metas=head_metas,
                head_consolidation=models_factory.HEAD_CONSOLIDATION)
        if model is None:
            LOG.warning('no checkpoint given: using randomly initialized '
                        '%s model', head_metas[0].dataset if head_metas
                        else 'cocokp')
            model = models_factory.Factory().from_scratch(
                head_metas or cocokp_head_metas(),
                generator=torch.Generator().manual_seed(0))
        self.device = torch.device('cuda' if device is None else device)
        if self.device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError("Predictor: no CUDA device found; pass "
                               "device='cpu' to run on the CPU")
        self.model = model.to(self.device).eval()
        self.head_metas = model.head_metas
        self.backbone_engine = backbone_engine
        self.bf16 = bf16
        self._tracking = isinstance(self.model, TrackingShell)
        self._prev_feats = None
        if self._tracking:
            if backbone_engine not in ('auto', 'flax') or bf16:
                raise ValueError(
                    'a tracking model serves on the module graph in '
                    f'float32, not backbone_engine={backbone_engine!r}, '
                    f'bf16={bf16}')
            self._backbone = None
            Signal.subscribe('eval_reset', self.reset_tracking)
        else:
            self._backbone = self._resolve_backbone_engine()
        self.processor = decoder.factory(self.head_metas)
        self.json_data = json_data

        self.preprocess = self._build_preprocess()
        self.last_decoder_time = 0.0
        self.last_nn_time = 0.0
        self.total_nn_time = 0.0
        self.total_decoder_time = 0.0
        self.total_images = 0

    def reset_tracking(self):
        """Drop the tracking model's cached features."""
        self._prev_feats = None

    def _resolve_backbone_engine(self):
        """The backbone forward ``fn(x) -> features`` (channels_last NCHW)
        of ``backbone_engine`` and ``bf16``, or None for the module graph
        in float32. Raises ``ValueError`` for an explicit engine on a
        backbone that does not fold."""
        engine = self.backbone_engine
        base_net = self.model.base_net
        if engine == 'auto':
            # JAX tries the fold and falls back on the flax graph when it
            # fails: any backbone but a BatchNorm ShuffleNetV2K
            foldable = isinstance(base_net, ShuffleNetV2K) \
                and base_net.norm == 'batch' and all(
                    (c // 2) % 128 == 0
                    for c in base_net.stages_out_channels[1:])
            engine = 'halves' if foldable else 'flax'
        dtype = torch.bfloat16 if self.bf16 else torch.float32
        if engine == 'flax':
            if not self.bf16:
                return None
            net = copy.deepcopy(base_net).to(dtype)
            return lambda x: net(x.to(dtype))
        try:
            folded = fused_inference.build_fused_backbone(self.model, dtype)
        except ValueError as e:
            raise ValueError(f'backbone engine {engine!r}: {e}') from None
        LOG.info('backbone engine: %s (%s)', engine, dtype)
        if engine == 'pallas':
            return fused_inference.build_pallas_forward(folded, dtype=dtype)
        if engine == 'dwpallas':
            folded = folded.with_mode('dwpallas')
        return lambda x: folded(x.to(dtype))

    def _forward(self, images):
        """Per-head fields of a (B, H, W, 3) float32 batch on the device:
        the backbone engine, then the heads on float32 features."""
        if self._backbone is None:
            return self.model(images)
        x = images.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        features = self._backbone(x).float()
        return tuple(hn(features) for hn in self.model.head_nets)

    def _tracking_fields(self, images):
        """The tracking model's fields of one frame: the backbone on the
        frame, the heads on [its features, the previous frame's]."""
        assert images.shape[0] == 1, \
            'tracking models process one frame at a time'
        feats = self.model.backbone(images)
        prev = self._prev_feats
        if prev is None or prev.shape != feats.shape:
            prev = feats  # first frame or resolution change
        self._prev_feats = feats
        return self.model.heads(torch.cat([feats, prev]))

    def _build_preprocess(self, long_edge=None):
        if long_edge is None:
            long_edge = self.long_edge
        return transforms.Compose([
            transforms.ImageTransform(_pil_image),
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
            fields = self._tracking_fields(images) if self._tracking \
                else self._forward(images)
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        self.last_nn_time = time.perf_counter() - start
        return list(fields)

    def _run_batch(self, batch):
        """Forward, decode and yield one collated batch (images, anns,
        metas), or (raw images, images, anns, metas)."""
        if len(batch) == 4:
            _, image_batch, gt_anns_batch, meta_batch = batch
        else:
            image_batch, gt_anns_batch, meta_batch = batch
        fields = self.fields_batch(image_batch)
        pred_batch = self.processor.batch_decode(fields)
        self.last_decoder_time = self.processor.last_decoder_time
        self.total_nn_time += self.last_nn_time
        self.total_decoder_time += self.last_decoder_time
        self.total_images += len(meta_batch)

        for pred, gt_anns, meta in zip(pred_batch, gt_anns_batch, meta_batch):
            pred = [ann.inverse_transform(meta) for ann in pred]
            gt_anns = [ann.inverse_transform(meta) for ann in gt_anns
                       if hasattr(ann, 'inverse_transform')]
            if self.json_data:
                pred = [ann.json_data() for ann in pred]
            yield pred, gt_anns, meta

    def _run_batches(self, batches):
        """The strict serving loop: each batch is forwarded, decoded and
        yielded before the next one is read."""
        for batch in batches:
            yield from self._run_batch(batch)

    def dataset(self, data):
        """Iterate a dataset of (image, anns, meta) samples in batches of
        ``batch_size``; yields (predictions, gt_anns, meta) per image."""
        yield from self._run_batches(
            collate_images_anns_meta(
                [data[i] for i in range(start, min(start + self.batch_size,
                                                   len(data)))])
            for start in range(0, len(data), self.batch_size))

    def dataloader(self, dataloader):
        """Iterate the collated batches of ``dataloader`` (e.g. a data
        module's ``eval_loader()``)."""
        yield from self._run_batches(iter(dataloader))

    def enumerated_dataloader(self, enumerated_dataloader):
        """As :meth:`dataloader`, for (index, batch) pairs."""
        yield from self._run_batches(
            batch for _, batch in iter(enumerated_dataloader))

    def images(self, file_names):
        file_names = list(file_names)
        data = _Images(
            file_names, _load_rgb, self.preprocess,
            lambda i: {'dataset_index': i, 'file_name': file_names[i]})
        yield from self.dataset(data)

    def numpy_images(self, numpy_images):
        """Images as (H, W, 3) uint8 arrays."""
        numpy_images = list(numpy_images)
        data = _Images(numpy_images, _pil_image, self.preprocess,
                       lambda i: {'dataset_index': i})
        yield from self.dataset(data)

    def image(self, file_name):
        return next(iter(self.images([file_name])))

    def numpy_image(self, image):
        return next(iter(self.numpy_images([image])))
