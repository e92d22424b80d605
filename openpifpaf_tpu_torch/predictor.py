"""High-level Predictor API (port of ``openpifpaf_tpu/predictor.py``).

Model -> forward -> decode (the decoder factory's ``Multi``), with
generators over image files, PIL images, numpy arrays, datasets and data
loaders; a tracking model's forward caches the previous frame's features.
A worker thread produces the batches ahead (load, preprocess, collate:
host work only); the forward and the decode run on the caller's thread.
The serving loop is pipelined one batch deep (``pipeline_decode``): batch
i+1's forward is queued on the card before batch i's decode runs, on a
side CUDA stream, so the card runs the forward while the host decodes.
``n_devices`` splits the forward batch over that many local devices
(:class:`.parallel.ShardedForward`), and ``spatial_devices`` each image's
height over that many of them (the ``('data', 'space')`` grid mesh).
Test-time options: the horizontal flip (``hflip_tta``), several scales
merged (``multi_scale``), and large batches forwarded in chunks
(``nn_chunk_size``, off by default). A list of JPEG files with a
``long_edge`` loads through the native threaded JPEG loader
(:mod:`.io.native`, ``native_io``) where it builds, as uint8 batches that
are normalised on the device; elsewhere through PIL.
"""

import copy
import logging
import queue
import threading
import time

import numpy as np
import torch

from . import datasets, decoder, headmeta, parallel, transforms
from .datasets.collate import collate_images_anns_meta
from .datasets.loader_with_reset import LoaderWithReset
from .models import factory as models_factory
from .models import fused_inference, shuffle_cuda
from .models.basenetworks import ShuffleNetV2K
from .models.heads import paf_hflip, pif_hflip
from .models.tracking import TrackingShell
from .plugins.coco.constants import cocokp_head_metas
from .signal_ import Signal
from .training import checkpoint as ckpt_mod
from .visualizer import Base as VisualizerBase

LOG = logging.getLogger(__name__)


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
    #: a batch of at least ``nn_chunk_threshold`` images whose size
    #: divides by ``nn_chunk_size`` runs its forward in chunks of that
    #: size (0 disables); not for tracking models. JAX chunks by 8; here
    #: it is off, because on an H100 chunks of 8 made a batch of 16 slower
    #: per image (``chip_smoke.py`` phase 17b, PERF.md)
    nn_chunk_size = 0
    nn_chunk_threshold = 16
    #: pad images up to the next multiple of this many pixels plus one,
    #: as the JAX Predictor does (it bounds the number of shapes)
    size_bucket = 128
    #: horizontal-flip test-time augmentation: forward the mirrored batch
    #: too, map its fields back (``pif_hflip``/``paf_hflip``) and average
    #: them with the direct fields before the one decode
    hflip_tta = False
    #: keypoint left/right mapping for ``hflip_tta`` (e.g. a plugin's
    #: HFLIP dict); None: derived from the keypoint names
    hflip_mapping = None
    #: multi-scale test-time augmentation of :meth:`images`: decode at
    #: these factors of the long edge and merge the annotations (OKS) and
    #: detections (IoU) greedily
    multi_scale = False
    multi_scale_factors = (1.0, 0.75, 1.5)
    multi_scale_oks_threshold = 0.8
    #: batches produced ahead by the worker thread; 0: produced on the
    #: caller's thread when the loop asks for them
    prefetch_depth = 2
    #: use the native C++ threaded JPEG loader when possible
    native_io = True
    #: the serving loop one batch deep: batch i+1's forward is queued
    #: before batch i's decode runs (``decoder.CifCaf`` decodes on a side
    #: CUDA stream, whose host syncs leave the forward's stream running);
    #: False: each batch forwarded, decoded and yielded before the next.
    #: Under it the NN time is the forward's device time (CUDA events)
    #: and the decoder time the host's time in the decode, so the split
    #: is approximate; eval keeps the strict loop unless asked
    pipeline_decode = True
    #: the CUDA events around the forward that ``fields_batch`` queued
    #: last (pipelined on the card), else None
    _nn_events = None
    #: devices each image's height is split over (with ``n_devices``)
    spatial_devices = None

    def __init__(self, checkpoint=None, head_metas=None, *, model=None,
                 device=None, json_data=False, backbone_engine='auto',
                 bf16=False, n_devices=None, spatial_devices=None,
                 mesh=None):
        """Without ``model``: the checkpoint at ``checkpoint`` (the port's,
        a reference ``.pkl`` or a published name of
        ``models.factory.CHECKPOINT_URLS``), with ``head_metas``
        consolidated as ``--head-consolidation`` says, else a
        ``shufflenetv2k16`` with ``head_metas`` (default: the cocokp
        heads), randomly initialised from seed 0.
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

        ``n_devices`` (more than 1) splits each forward batch over the
        first that many CUDA devices of the machine, one replica of the
        serving forward on each, and gathers the fields on the first for
        the decode; fewer visible cards raise ``ValueError``. With
        ``device='cpu'`` the replicas are all on the CPU.
        ``spatial_devices`` (more than 1, dividing ``n_devices``) makes
        that a ``('data', 'space')`` grid: each image's height is split
        over ``spatial_devices`` of them with halo exchanges, on the
        module graph or the backbone engine, and the fields are gathered
        whole for the decode. ``mesh`` (a mesh of :mod:`.parallel`)
        serves over its devices in place of the one these two make: e.g.
        ``parallel.grid_mesh(spatial=S, devices=[card] * S)``, every shard
        of the height on one card.
        """
        if backbone_engine not in BACKBONE_ENGINES:
            raise ValueError(f'unknown backbone engine {backbone_engine!r}; '
                             f'one of {BACKBONE_ENGINES}')
        if model is None and checkpoint is not None:
            model, _ = ckpt_mod.load_shell(
                models_factory.resolve_checkpoint(checkpoint),
                head_metas=head_metas,
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
        self.n_devices = n_devices
        self.spatial_devices = spatial_devices
        self._sharded = None
        if mesh is None and n_devices is not None and n_devices > 1:
            mesh = self._mesh(n_devices, spatial_devices or 1)
        if mesh is not None:
            self._sharded = self._sharded_forward(mesh)
        self.processor = decoder.factory(self.head_metas)
        self.json_data = json_data
        self._warned_no_hflip = set()

        self.preprocess = self._build_preprocess()
        #: the loader that :meth:`images` took last: 'native' or 'pil'
        self.last_image_loader = None
        self.last_decoder_time = 0.0
        self.last_nn_time = 0.0
        self.total_nn_time = 0.0
        self.total_decoder_time = 0.0
        self.total_images = 0

    def reset_tracking(self):
        """Drop the tracking model's cached features."""
        self._prev_feats = None

    def _engine(self, model):
        """The engine that ``backbone_engine`` resolves to for ``model``,
        and the backbone's dtype."""
        engine = self.backbone_engine
        base_net = model.base_net
        if engine == 'auto':
            # JAX tries the fold and falls back on the flax graph when it
            # fails: any backbone but a BatchNorm ShuffleNetV2K
            foldable = isinstance(base_net, ShuffleNetV2K) \
                and base_net.norm == 'batch' and all(
                    (c // 2) % 128 == 0
                    for c in base_net.stages_out_channels[1:])
            engine = 'halves' if foldable else 'flax'
        return engine, torch.bfloat16 if self.bf16 else torch.float32

    def _fold(self, model, engine, dtype):
        try:
            folded = fused_inference.build_fused_backbone(model, dtype)
        except ValueError as e:
            raise ValueError(f'backbone engine {engine!r}: {e}') from None
        LOG.info('backbone engine: %s (%s)', engine, dtype)
        return folded.with_mode('dwpallas') if engine == 'dwpallas' \
            else folded

    def _resolve_backbone_engine(self, model=None):
        """The backbone forward ``fn(x) -> features`` (channels_last NCHW)
        of ``backbone_engine`` and ``bf16`` for ``model`` (default the
        Predictor's), or None for the module graph in float32. Raises
        ``ValueError`` for an explicit engine on a backbone that does not
        fold."""
        model = model or self.model
        engine, dtype = self._engine(model)
        if engine == 'flax':
            if not self.bf16:
                return None
            net = copy.deepcopy(model.base_net).to(dtype)
            return lambda x: net(x.to(dtype))
        folded = self._fold(model, engine, dtype)
        if engine == 'pallas':
            return fused_inference.build_pallas_forward(folded, dtype=dtype)
        return lambda x: folded(x.to(dtype))

    def _spatial_forward(self, replicas):
        """``fn(images, axis) -> field rows``: the backbone engine on the
        shards of ``axis`` (``replicas[k]`` the model on local shard k's
        device), then the heads on float32 features."""
        from .parallel import spatial_model
        engine, dtype = self._engine(replicas[0])
        if engine == 'flax':
            nets = [r.base_net for r in replicas]
            if self.bf16:
                nets = [copy.deepcopy(n).to(dtype) for n in nets]

            def backbone(rows):
                if self.bf16:
                    rows = rows.map(lambda k, x: x.to(dtype))
                return spatial_model.backbone_rows(nets, rows, False)
        else:
            folds = [self._fold(r, engine, dtype) for r in replicas]
            backbone = fused_inference.block_rows_forward(
                folds, dtype, shuffle_cuda.fused_block) \
                if engine == 'pallas' else \
                fused_inference.folded_rows_forward(folds, dtype)

        def forward(images, axis):
            features = backbone(spatial_model.images_to_rows(images, axis))
            if engine != 'flax' or self.bf16:
                features = features.map(lambda k, x: x.float())
            return spatial_model.heads_rows([r.head_nets for r in replicas],
                                            features)

        return forward

    def _mesh(self, n_devices, spatial):
        """The grid mesh of ``n_devices`` devices of the Predictor's
        device type, each image's height over ``spatial`` of them."""
        if self.device.type == 'cuda':
            visible = torch.cuda.device_count()
            if visible < n_devices:
                raise ValueError(
                    f'n_devices={n_devices}: only {visible} CUDA '
                    'device(s) visible')
        return parallel.grid_mesh(n_devices, spatial=spatial,
                                  device_type=self.device.type)

    def _sharded_forward(self, mesh):
        """The forward over ``mesh``'s devices: each replica of the model
        runs the backbone engine resolved on it; on a grid mesh each
        image's height is split over its space axis."""
        if self._tracking:
            raise ValueError('a tracking model serves one frame at a time '
                             'on one device, not n_devices='
                             f'{len(mesh.devices)}')

        def forward(replica):
            backbone = self._resolve_backbone_engine(replica)
            return lambda images: self._forward(images, replica, backbone)

        return parallel.ShardedForward(self.model, mesh=mesh,
                                       forward=forward,
                                       spatial_forward=self._spatial_forward)

    def _forward(self, images, model=None, backbone=None):
        """Per-head fields of a (B, H, W, 3) float32 batch on the device:
        the backbone engine, then the heads on float32 features (of
        ``model``, default the Predictor's, and its ``backbone``)."""
        if model is None:
            if self._sharded is not None:
                return self._sharded(images)
            model, backbone = self.model, self._backbone
        if backbone is None:
            return model(images)
        x = images.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        features = backbone(x).float()
        return tuple(hn(features) for hn in model.head_nets)

    def _nn(self, images):
        """The forward of a batch; from ``nn_chunk_threshold`` images up,
        a batch whose size divides by ``nn_chunk_size`` runs in chunks of
        that size and their fields are concatenated."""
        b = images.shape[0]
        chunk = self.nn_chunk_size
        if not chunk or b < self.nn_chunk_threshold or b % chunk:
            return self._forward(images)
        parts = [self._forward(images[i:i + chunk])
                 for i in range(0, b, chunk)]
        return tuple(torch.cat(fields) for fields in zip(*parts))

    @staticmethod
    def _hflip_mapping(keypoints):
        """Left/right name swap by convention (left_/right_ and L_/R_
        prefixes, _left/_right and _l/_r suffixes). Plugins with other
        conventions set ``Predictor.hflip_mapping`` to their HFLIP dict."""
        pairs = (('left_', 'right_', 'prefix'), ('L_', 'R_', 'prefix'),
                 ('_left', '_right', 'suffix'), ('_l', '_r', 'suffix'))
        mapping = {}
        for name in keypoints:
            for a, b, kind in pairs:
                for src, dst in ((a, b), (b, a)):
                    if kind == 'prefix' and name.startswith(src):
                        other = dst + name[len(src):]
                    elif kind == 'suffix' and name.endswith(src):
                        other = name[:-len(src)] + dst
                    else:
                        continue
                    if other in keypoints:
                        mapping[name] = other
                if name in mapping:
                    break
        return mapping

    def _hflip_tta_fields(self, images):
        """The direct fields averaged with the mirrored batch's fields
        mapped back. The whole padded batch is mirrored, so its padding
        moves to the left, and in cell units ``x_back = (W - 1) - x``. A
        head without keypoints (CifDet) or without a left/right mapping
        keeps its direct fields."""
        fields = self._nn(images)
        mirrored = self._nn(images.flip(2))
        out = []
        for field, flipped, meta in zip(fields, mirrored, self.head_metas):
            if getattr(meta, 'keypoints', None) is None:
                out.append(field)
                continue
            hflip = self.hflip_mapping or \
                self._hflip_mapping(list(meta.keypoints))
            if not hflip:
                if meta.name not in self._warned_no_hflip:
                    self._warned_no_hflip.add(meta.name)
                    LOG.warning(
                        'no left/right mapping derivable for head %s: '
                        'skipping hflip TTA for it (set '
                        'Predictor.hflip_mapping explicitly)', meta.name)
                out.append(field)
                continue
            w_cells = field.shape[-1]
            if isinstance(meta, headmeta.Caf):
                back = paf_hflip(flipped, list(meta.keypoints),
                                 list(meta.skeleton), hflip)
                back[:, :, 2] += w_cells - 1.0
                back[:, :, 4] += w_cells - 1.0
            elif isinstance(meta, headmeta.Cif):
                back = pif_hflip(flipped, list(meta.keypoints), hflip)
                back[:, :, 2] += w_cells - 1.0
            else:
                out.append(field)
                continue
            out.append(0.5 * (field + back))
        return tuple(out)

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
        original meta. A uint8 batch (the native loader's) is padded with
        the ImageNet mean colour, which the normalisation on the device
        turns into about 0, as JAX pads it.
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
        if image_batch.dtype == np.uint8:
            out[...] = np.asarray(transforms.IMAGENET_MEAN_U8,
                                  dtype=np.uint8)
        out[:, :h, :w] = image_batch
        return out

    @staticmethod
    def _normalized_np(img):
        if img.dtype == np.uint8:
            return ((img.astype(np.float32) / 255.0
                     - transforms.IMAGENET_MEAN) / transforms.IMAGENET_STD)
        return np.asarray(img, dtype=np.float32)

    @staticmethod
    def _normalized(images):
        """(B, H, W, 3) uint8 pixels on the device to the float32 input of
        the forward, as JAX's in-graph ``forward_u8``: ``x / 255``, then
        ``(x - mean) / std`` (divisions by tensors, so that CUDA rounds
        them as the CPU does)."""
        kw = dict(dtype=torch.float32, device=images.device)
        x = images.to(torch.float32) / torch.tensor(255.0, **kw)
        return ((x - torch.tensor(transforms.IMAGENET_MEAN, **kw))
                / torch.tensor(transforms.IMAGENET_STD, **kw))

    def fields_batch(self, image_batch):
        """Per-head (B, F, C, H, W) fields of a (B, H, W, 3) float batch,
        or of a uint8 batch of raw pixels (normalised on the device), on
        ``self.device``. Strict (or on the CPU) the card is synchronised
        and ``last_nn_time`` is the host's time; pipelined on the card
        the forward is only queued, and its time (upload and forward) is
        read later from CUDA events recorded on the forward's stream."""
        start = time.perf_counter()
        queued = self.pipeline_decode and self.device.type == 'cuda'
        if queued:
            begin = torch.cuda.Event(enable_timing=True)
            begin.record()
        image_batch = np.asarray(image_batch)
        if image_batch.dtype != np.uint8:
            image_batch = image_batch.astype(np.float32, copy=False)
        image_batch = self._bucket_pad(image_batch)
        images = torch.from_numpy(image_batch).to(self.device)
        with torch.inference_mode():
            if images.dtype == torch.uint8:
                images = self._normalized(images)
            if self._tracking:
                fields = self._tracking_fields(images)
            elif self.hflip_tta:
                fields = self._hflip_tta_fields(images)
            else:
                fields = self._nn(images)
        if queued:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._nn_events = (begin, end)
        else:
            if self.device.type == 'cuda':
                torch.cuda.synchronize(self.device)
            self.last_nn_time = time.perf_counter() - start
            self._nn_events = None
        return list(fields)

    def _nn_seconds(self):
        """``nn_time()`` of the forward that :meth:`fields_batch` ran
        last: from its CUDA events, waited for when called, or the host's
        time it measured."""
        if self._nn_events is None:
            seconds = self.last_nn_time
            return lambda: seconds
        begin, end = self._nn_events

        def nn_time():
            end.synchronize()
            return begin.elapsed_time(end) / 1e3

        return nn_time

    def _dispatch_batch(self, batch):
        """Forward a collated batch and queue its decode (pipelined, with
        a deferred decode) or decode it (strict); returns what
        :meth:`_materialize_batch` finishes. A decode that ran here has
        its time read here."""
        if len(batch) == 4:
            _, image_batch, gt_anns_batch, meta_batch = batch
        else:
            image_batch, gt_anns_batch, meta_batch = batch
        if VisualizerBase.all_indices and len(image_batch):
            # the backdrop of the decoder's debug plots: batch element 0
            VisualizerBase.processed_image(
                self._normalized_np(np.asarray(image_batch[0])))
        fields = self.fields_batch(image_batch)
        nn_time = self._nn_seconds()
        if self.pipeline_decode \
                and hasattr(self.processor, 'batch_decode_deferred'):
            deferred = self.processor.batch_decode_deferred(fields)

            def materialize():
                return (deferred(), self.processor.last_decoder_time)
        else:
            done = (self.processor.batch_decode(fields),
                    self.processor.last_decoder_time)

            def materialize():
                return done
        return materialize, nn_time, gt_anns_batch, meta_batch

    def _materialize_batch(self, staged):
        """Run a dispatched batch's decode and yield (predictions,
        ground truth, meta) per image."""
        materialize, nn_time, gt_anns_batch, meta_batch = staged
        pred_batch, self.last_decoder_time = materialize()
        self.last_nn_time = nn_time()
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

    def _run_batch(self, batch):
        """Forward, decode and yield one collated batch (images, anns,
        metas), or (raw images, images, anns, metas)."""
        yield from self._materialize_batch(self._dispatch_batch(batch))

    def _run_batches(self, batches, pipelined=None):
        """The serving loop over collated batches and
        ``LoaderWithReset.RESET`` markers (default ``pipelined``:
        ``pipeline_decode``). Strict: each batch forwarded, decoded and
        yielded before the next is taken. Pipelined: batch i+1 is taken
        and dispatched before batch i is materialised; if taking or
        dispatching batch i+1 fails, batch i's results are yielded first,
        then the exception is raised. A marker emits ``eval_reset`` after
        every batch before it was decoded and yielded."""
        if pipelined is None:
            pipelined = self.pipeline_decode
        if not pipelined:
            for batch in batches:
                if batch is LoaderWithReset.RESET:
                    Signal.emit('eval_reset')
                    continue
                yield from self._run_batch(batch)
            return

        def flush(pending):
            if pending is not None:
                yield from self._materialize_batch(pending)

        pending = None
        it = iter(batches)
        while True:
            try:
                batch = next(it)
            except StopIteration:
                break
            except BaseException:
                yield from flush(pending)
                raise
            if batch is LoaderWithReset.RESET:
                yield from flush(pending)
                pending = None
                Signal.emit('eval_reset')
                continue
            try:
                staged = self._dispatch_batch(batch)
            except BaseException:
                yield from flush(pending)
                raise
            yield from flush(pending)
            pending = staged
        yield from flush(pending)

    def _prefetched(self, batches):
        """The items of ``batches``, produced up to ``prefetch_depth``
        ahead by a worker thread (host work only). A worker exception is
        raised here after the items before it. ``LoaderWithReset.RESET``
        markers pass through to the serving loop, which emits
        ``eval_reset`` for them on the caller's thread."""
        if not self.prefetch_depth:
            return iter(batches)
        return self._worker_items(batches)

    def _worker_items(self, batches):
        fifo = queue.Queue(maxsize=self.prefetch_depth)
        done = object()
        stop = threading.Event()

        def put(item):
            while not stop.is_set():
                try:
                    fifo.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for batch in batches:
                    if not put(batch):
                        return
                put(done)
            except BaseException as exc:  # raised on the caller's thread
                put(exc)

        worker = threading.Thread(target=produce, daemon=True)
        worker.start()
        try:
            while True:
                item = fifo.get()
                if item is done:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # the caller stopped early: let the worker end
            stop.set()
            worker.join()

    def dataset(self, data):
        """Iterate a dataset of (image, anns, meta) samples in batches of
        ``batch_size``; yields (predictions, gt_anns, meta) per image."""
        def batches():
            for start in range(0, len(data), self.batch_size):
                yield collate_images_anns_meta(
                    [data[i] for i in range(
                        start, min(start + self.batch_size, len(data)))])

        yield from self._run_batches(self._prefetched(batches()))

    def dataloader(self, dataloader):
        """Iterate the collated batches of ``dataloader`` (e.g. a data
        module's ``eval_loader()``); a ``LoaderWithReset`` resets between
        sequences after the last frame of one was decoded."""
        if isinstance(dataloader, LoaderWithReset):
            batches = dataloader.marked()
        else:
            batches = iter(dataloader)
        yield from self._run_batches(self._prefetched(batches))

    def enumerated_dataloader(self, enumerated_dataloader):
        """As :meth:`dataloader`, for (index, batch) pairs, each pulled on
        the caller's thread after the previous batch was yielded (the
        strict loop): behind an ``enumerate`` a ``LoaderWithReset`` cannot
        be seen, and pulled ahead it would emit ``eval_reset`` before the
        last frame of a sequence was decoded and yielded."""
        yield from self._run_batches(
            (batch for _, batch in enumerated_dataloader), pipelined=False)

    @staticmethod
    def _pose_oks(ann_a, ann_b, sigmas):
        """Object keypoint similarity between two annotations in the same
        (original image) coordinate frame."""
        a, b = ann_a.data, ann_b.data
        vis = (a[:, 2] > 0) & (b[:, 2] > 0)
        if not np.any(vis):
            return 0.0
        ref = b[b[:, 2] > 0]
        area = ((ref[:, 0].max() - ref[:, 0].min())
                * (ref[:, 1].max() - ref[:, 1].min()))
        scale2 = max(float(area), 1.0)
        k = 2.0 * np.asarray(sigmas, dtype=np.float32)[vis]
        d2 = np.sum((a[vis, :2] - b[vis, :2]) ** 2, axis=1)
        return float(np.mean(np.exp(-d2 / (2.0 * scale2 * k ** 2))))

    def _merge_annotations(self, annotations):
        """Greedy OKS suppression across the scales: the highest scores
        are kept, their near-duplicates dropped (Python's stable sort, in
        the scales' order)."""
        if not annotations:
            return []
        sigmas = getattr(self.head_metas[0], 'sigmas', None)
        if sigmas is None:
            sigmas = [0.05] * annotations[0].data.shape[0]
        kept = []
        for ann in sorted(annotations, key=lambda a: a.score, reverse=True):
            if all(self._pose_oks(ann, k, sigmas)
                   < self.multi_scale_oks_threshold for k in kept):
                kept.append(ann)
        return kept

    @staticmethod
    def _merge_detections(dets, iou_threshold=0.7):
        """Greedy IoU suppression of the scales' duplicate detections of
        one category."""
        def iou(a, b):
            ax, ay, aw, ah = a.bbox
            bx, by, bw, bh = b.bbox
            ix = max(0.0, min(ax + aw, bx + bw) - max(ax, bx))
            iy = max(0.0, min(ay + ah, by + bh) - max(ay, by))
            inter = ix * iy
            union = aw * ah + bw * bh - inter
            return inter / union if union > 0 else 0.0

        kept = []
        for det in sorted(dets, key=lambda d: d.score or 0.0, reverse=True):
            if all(det.category_id != k.category_id
                   or iou(det, k) < iou_threshold for k in kept):
                kept.append(det)
        return kept

    def _images_multiscale(self, file_names):
        """Each image decoded at every factor of ``multi_scale_factors``
        of the long edge (default 641), the annotations merged."""
        base_long_edge = self.long_edge or 641
        json_data, self.json_data = self.json_data, False
        try:
            for file_name in file_names:
                merged_input = []
                last_meta = None
                for factor in self.multi_scale_factors:
                    long_edge = max(
                        33, int(round(base_long_edge * factor / 16)) * 16 + 1)
                    data = datasets.ImageList(
                        [file_name],
                        preprocess=self._build_preprocess(long_edge))
                    for pred, _, meta in self.dataset(data):
                        # already in the original image's coordinates
                        merged_input.extend(pred)
                        last_meta = meta
                keypointed = [a for a in merged_input if hasattr(a, 'data')]
                others = [a for a in merged_input if not hasattr(a, 'data')]
                merged = (self._merge_annotations(keypointed)
                          + self._merge_detections(others))
                if json_data:
                    merged = [ann.json_data() for ann in merged]
                yield merged, [], last_meta
        finally:
            self.json_data = json_data

    def _native_loader(self, file_names):
        """The native JPEG loader where JAX's Predictor takes it (JPEG
        files, a ``long_edge``, not tracking; the port has no raw-image
        option) and where it builds; else None."""
        if not (self.native_io and self.long_edge and not self._tracking):
            return None
        if not all(f.lower().endswith(('.jpg', '.jpeg'))
                   for f in file_names):
            return None
        from .io import native
        if not native.native_available():
            return None
        return native.NativeImageLoader(long_edge=self.long_edge)

    def _images_native(self, file_names, loader):
        def batches():
            for start in range(0, len(file_names), self.batch_size):
                paths = file_names[start:start + self.batch_size]
                images, metas = loader.load_batch_uint8(paths)
                yield images, [[] for _ in metas], metas

        yield from self._run_batches(self._prefetched(batches()))

    def images(self, file_names):
        file_names = list(file_names)
        if self.multi_scale:
            yield from self._images_multiscale(file_names)
            return
        native_loader = self._native_loader(file_names)
        self.last_image_loader = 'pil' if native_loader is None \
            else 'native'
        LOG.info('loading %d images with the %s loader', len(file_names),
                 'native JPEG' if native_loader else 'PIL')
        if native_loader is not None:
            yield from self._images_native(file_names, native_loader)
            return
        yield from self.dataset(datasets.ImageList(
            file_names, preprocess=self.preprocess))

    def pil_images(self, pil_images):
        yield from self.dataset(datasets.PilImageList(
            list(pil_images), preprocess=self.preprocess))

    def numpy_images(self, numpy_images):
        """Images as (H, W, 3) uint8 arrays."""
        yield from self.dataset(datasets.NumpyImageList(
            list(numpy_images), preprocess=self.preprocess))

    def image(self, file_name):
        return next(iter(self.images([file_name])))

    def pil_image(self, image):
        return next(iter(self.pil_images([image])))

    def numpy_image(self, image):
        return next(iter(self.numpy_images([image])))
