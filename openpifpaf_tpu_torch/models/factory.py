"""Network factory (port of ``openpifpaf_tpu/models/factory.py``:
``BASE_FACTORIES`` with every backbone of the JAX registry, the backbone
flags, ``Factory`` and the registry of published checkpoint names,
``CHECKPOINT_URLS``, with ``resolve_checkpoint``).

Random initialisation follows flax's defaults, drawn from an explicit
``torch.Generator``: truncated-normal (LeCun) convolution kernels, zero
biases, BatchNorm and GroupNorm scale 1, bias 0, running mean 0 and
variance 1.
"""

import hashlib
import logging
import math
import os
from typing import Optional, Sequence

import torch
from torch import nn

from .. import headmeta
from . import basenetworks, heads, tracking
from .shell import Shell, assign_strides

LOG = logging.getLogger(__name__)

#: family-level backbone options, set by ``cli``/``configure`` and written
#: into checkpoints, as in the JAX package
SHUFFLENETV2K_OPTIONS = {
    'kernel': 5,
    'stage4_dilation': 1,
    'input_conv2_stride': 0,
    'input_conv2_outchannels': None,
    'conv5_as_stage': False,
    'norm': 'batch',
    'non_linearity': 'relu',
}
RESNET_OPTIONS = {
    'pool0_stride': 0,
    'input_conv_stride': 2,
    'input_conv2_stride': 0,
    'block5_dilation': 1,
    'remove_last_block': False,
}


def _snk(repeats, channels):
    return lambda: basenetworks.ShuffleNetV2K(
        repeats, channels, **SHUFFLENETV2K_OPTIONS)


def _resnet(layers, **fixed):
    return lambda: basenetworks.Resnet(layers, **fixed, **RESNET_OPTIONS)


BASE_FACTORIES = {
    'shufflenetv2k16': _snk([4, 8, 4], [24, 348, 696, 1392, 1392]),
    'shufflenetv2k20': _snk([5, 10, 5], [32, 512, 1024, 2048, 2048]),
    'shufflenetv2k30': _snk([8, 16, 6], [32, 512, 1024, 2048, 2048]),
    'shufflenetv2k44': _snk([12, 24, 8], [32, 512, 1024, 2048, 2048]),
    'shufflenetv2kx5': _snk([6, 13, 6], [42, 640, 1280, 2560, 2560]),
    # torchvision's ShuffleNetV2 (k=3 blocks, max-pool removed -> stride 16)
    'shufflenetv2x1': lambda: basenetworks.ShuffleNetV2K(
        [4, 8, 4], [24, 116, 232, 464, 1024], kernel=3),
    'shufflenetv2x2': lambda: basenetworks.ShuffleNetV2K(
        [4, 8, 4], [24, 244, 488, 976, 2048], kernel=3),
    'resnet18': _resnet((2, 2, 2, 2), base_features=64, basic_block=True),
    'resnet50': _resnet((3, 4, 6, 3)),
    'resnet101': _resnet((3, 4, 23, 3)),
    'resnet152': _resnet((3, 8, 36, 3)),
    'resnext50': _resnet((3, 4, 6, 3), groups=32, width_per_group=4),
    'resnext101': _resnet((3, 4, 23, 3), groups=32, width_per_group=8),
    'mobilenetv2': basenetworks.MobileNetV2,
    'mobilenetv3large': lambda: basenetworks.MobileNetV3('large'),
    'mobilenetv3small': lambda: basenetworks.MobileNetV3('small'),
    'squeezenet': basenetworks.SqueezeNet,
}

# tracking backbones: the same networks; a tracking model is told by its
# head metas (``build_shell``), and the Predictor caches its features
BASE_FACTORIES.update({
    'tshufflenetv2k16': BASE_FACTORIES['shufflenetv2k16'],
    'tshufflenetv2k30': BASE_FACTORIES['shufflenetv2k30'],
    'tresnet50': BASE_FACTORIES['resnet50'],
})

#: published checkpoint name -> url or path (filled by the plugins)
CHECKPOINT_URLS = {}

#: the value of a checkpoint name whose pretrained weights are not
#: published
PRETRAINED_UNAVAILABLE = object()

#: --head-consolidation default
HEAD_CONSOLIDATION = 'filter_and_extend'

#: --cf4-dropout
CF4_OPTIONS = {'dropout_p': 0.0}


def cli(parser):
    """Network flags of the JAX package's ``models/factory.py::cli``."""
    group = parser.add_argument_group('network')
    group.add_argument('--head-consolidation',
                       choices=('keep', 'create', 'filter_and_extend'),
                       default=HEAD_CONSOLIDATION,
                       help='consolidation strategy for a checkpoint\'s '
                            'head networks and the heads specified by the '
                            'datamodule')
    group.add_argument('--cf4-dropout', default=0.0, type=float,
                       help='CompositeField4 dropout probability')
    group.add_argument('--no-download-progress', dest='download_progress',
                       default=True, action='store_false',
                       help='(compat) nothing is downloaded here')
    # reference-compat: torchvision-pretrained initialization switches.
    # From-scratch init is always random here; these are accepted so
    # reference command lines keep working.
    for name in ('resnet', 'shufflenetv2', 'mobilenetv2', 'mobilenetv3',
                 'squeezenet'):
        group.add_argument(f'--{name}-no-pretrain',
                           dest=f'{name}_pretrained',
                           default=True, action='store_false',
                           help='(compat) from-scratch init is always '
                                'random here')
    group = parser.add_argument_group('shufflenetv2k')
    group.add_argument('--shufflenetv2k-input-conv2-stride',
                       default=SHUFFLENETV2K_OPTIONS['input_conv2_stride'],
                       type=int,
                       help='stride of the optional 2nd input convolution')
    group.add_argument('--shufflenetv2k-input-conv2-outchannels',
                       default=SHUFFLENETV2K_OPTIONS['input_conv2_outchannels'],
                       type=int,
                       help='out channels of the optional 2nd input conv')
    group.add_argument('--shufflenetv2k-stage4-dilation',
                       default=SHUFFLENETV2K_OPTIONS['stage4_dilation'],
                       type=int, help='dilation factor of stage 4')
    group.add_argument('--shufflenetv2k-kernel',
                       default=SHUFFLENETV2K_OPTIONS['kernel'], type=int,
                       help='kernel width')
    group.add_argument('--shufflenetv2k-conv5-as-stage',
                       default=False, action='store_true')
    norm_group = group.add_mutually_exclusive_group()
    norm_group.add_argument('--shufflenetv2k-instance-norm',
                            default=False, action='store_true')
    norm_group.add_argument('--shufflenetv2k-group-norm',
                            default=False, action='store_true')
    group.add_argument('--shufflenetv2k-leaky-relu',
                       default=False, action='store_true')

    group = parser.add_argument_group('ResNet')
    group.add_argument('--resnet-pool0-stride',
                       default=RESNET_OPTIONS['pool0_stride'], type=int,
                       help='stride of zero removes the pooling op')
    group.add_argument('--resnet-input-conv-stride',
                       default=RESNET_OPTIONS['input_conv_stride'], type=int,
                       help='stride of the input convolution')
    group.add_argument('--resnet-input-conv2-stride',
                       default=RESNET_OPTIONS['input_conv2_stride'], type=int,
                       help='stride of the optional 2nd input convolution')
    group.add_argument('--resnet-block5-dilation',
                       default=RESNET_OPTIONS['block5_dilation'], type=int,
                       help='use dilated convs in block5')
    group.add_argument('--resnet-remove-last-block',
                       default=False, action='store_true',
                       help='create a network without the last block')


def configure(args):
    global HEAD_CONSOLIDATION
    HEAD_CONSOLIDATION = args.head_consolidation
    CF4_OPTIONS['dropout_p'] = args.cf4_dropout
    SHUFFLENETV2K_OPTIONS.update(
        input_conv2_stride=args.shufflenetv2k_input_conv2_stride,
        input_conv2_outchannels=args.shufflenetv2k_input_conv2_outchannels,
        stage4_dilation=args.shufflenetv2k_stage4_dilation,
        kernel=args.shufflenetv2k_kernel,
        conv5_as_stage=args.shufflenetv2k_conv5_as_stage,
    )
    if args.shufflenetv2k_instance_norm:
        SHUFFLENETV2K_OPTIONS['norm'] = 'instance'
    if args.shufflenetv2k_group_norm:
        SHUFFLENETV2K_OPTIONS['norm'] = 'group'
    if args.shufflenetv2k_leaky_relu:
        SHUFFLENETV2K_OPTIONS['non_linearity'] = 'leaky_relu'

    RESNET_OPTIONS.update(
        pool0_stride=args.resnet_pool0_stride,
        input_conv_stride=args.resnet_input_conv_stride,
        input_conv2_stride=args.resnet_input_conv2_stride,
        block5_dilation=args.resnet_block5_dilation,
        remove_last_block=args.resnet_remove_last_block,
    )


def base_factory(name):
    """The constructor of backbone ``name``; plugins add backbones
    (``cifar10net``) when they register, so an unknown name registers them
    first. Raises ``ValueError`` for a name no one registers."""
    if name not in BASE_FACTORIES:
        from .. import plugin
        plugin.register()
    if name not in BASE_FACTORIES:
        raise ValueError(f'unknown base network {name!r}; '
                         f'available: {sorted(BASE_FACTORIES)}')
    return BASE_FACTORIES[name]


#: std of a standard normal truncated to [-2, 2]: flax's
#: ``variance_scaling`` divides by it so the kernel keeps variance 1/fan_in
_TRUNC_STD = 0.87962566103423978


def init_like_flax(model: nn.Module, generator: torch.Generator):
    """Re-initialise ``model`` in place with flax's default initialisers."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, nn.Conv2d):
                fan_in = module.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
                nn.init.trunc_normal_(module.weight, std=std, a=-2.0 * std,
                                      b=2.0 * std, generator=generator)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, (nn.BatchNorm2d, nn.GroupNorm)):
                module.reset_parameters()
    return model


class Factory:
    base_name: str = 'shufflenetv2k16'
    upsample_stride: int = 1

    def __init__(self, base_name: Optional[str] = None, *,
                 upsample_stride: Optional[int] = None):
        if base_name is not None:
            self.base_name = base_name
        if upsample_stride is not None:
            self.upsample_stride = upsample_stride

    def from_scratch(self, head_metas: Sequence[headmeta.Base], *,
                     generator: Optional[torch.Generator] = None,
                     base_net: Optional[nn.Module] = None) -> Shell:
        """Shell with randomly initialised weights. ``base_net`` overrides
        the ``base_name`` backbone (e.g. a narrow ShuffleNetV2K)."""
        if base_net is None:
            base_net = base_factory(self.base_name)()
        for meta in head_metas:
            meta.upsample_stride = self.upsample_stride
        assign_strides(head_metas, base_net.stride)
        return build_shell(base_net, head_metas, generator=generator)


def build_shell(base_net, head_metas, *, generator=None):
    """Shell of ``base_net`` and a CompositeField4 per meta (with the
    ``--cf4-dropout`` probability), or for tracking metas a TrackingShell
    of ``TBaseSingleImage`` and ``Tcaf`` heads (no dropout, as in JAX),
    initialised like flax from ``generator`` (default: seed 0)."""
    if any(isinstance(meta, (headmeta.Tcaf, headmeta.TSingleImageCif,
                             headmeta.TSingleImageCaf))
           for meta in head_metas):
        head_nets = [
            tracking.Tcaf(meta, base_net.out_features)
            if isinstance(meta, headmeta.Tcaf)
            else tracking.TBaseSingleImage(meta, base_net.out_features)
            for meta in head_metas]
        model = tracking.TrackingShell(base_net, head_nets)
    else:
        head_nets = [heads.CompositeField4(
            meta, base_net.out_features, dropout_p=CF4_OPTIONS['dropout_p'])
            for meta in head_metas]
        model = Shell(base_net, head_nets)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_like_flax(model, generator)
    return model.to(memory_format=torch.channels_last)


def _registered_urls():
    """``CHECKPOINT_URLS`` after the plugins have registered their names."""
    from .. import plugin
    plugin.register()
    return CHECKPOINT_URLS


def local_checkpoint_path(checkpoint: str):
    if os.path.exists(checkpoint):
        return checkpoint
    urls = _registered_urls()
    if checkpoint in urls:
        return urls[checkpoint]
    return None


def checkpoint_cache_dir():
    """The download cache, shared with the JAX package: a reference
    ``.pkl`` that one package fetched serves the other."""
    return os.environ.get(
        'OPENPIFPAF_TPU_CACHE',
        os.path.join(os.path.expanduser('~'), '.cache', 'openpifpaf_tpu'))


def resolve_checkpoint(checkpoint: str) -> str:
    """A checkpoint argument as a local path.

    Accepts a checkpoint of the port (the path without ``.json``/``.pt``),
    a reference ``.pkl`` file, or a published checkpoint name of
    ``CHECKPOINT_URLS``: its file is downloaded once into
    :func:`checkpoint_cache_dir` (as ``.partial``, then renamed), and a
    file name that ends in ``-<8 hex digits>`` must prefix the sha256 of
    the file's contents, as torch.hub checks it. The ``.pkl`` converts on
    load (``training/checkpoint.py::load_shell``).
    """
    if os.path.exists(checkpoint) or os.path.exists(checkpoint + '.json'):
        return checkpoint

    urls = _registered_urls()
    url = urls.get(checkpoint)
    if url is None:
        return checkpoint  # the loader raises with context
    if url is PRETRAINED_UNAVAILABLE:
        available = sorted(k for k, v in urls.items()
                           if v is not PRETRAINED_UNAVAILABLE)
        raise ValueError(
            f'no pretrained weights published for {checkpoint!r}; '
            f'available: {available}')
    if os.path.exists(url):
        return url

    file_name = os.path.basename(url)
    cache_dir = checkpoint_cache_dir()
    local = os.path.join(cache_dir, file_name)
    if not os.path.exists(local):
        import urllib.request
        os.makedirs(cache_dir, exist_ok=True)
        LOG.info('downloading %s -> %s', url, local)
        tmp = local + '.partial'
        urllib.request.urlretrieve(url, tmp)
        os.replace(tmp, local)

    stem = file_name.rsplit('.', 1)[0]
    suffix = stem.rsplit('-', 1)[-1]
    if len(suffix) == 8 and all(c in '0123456789abcdef' for c in suffix):
        sha = hashlib.sha256()
        with open(local, 'rb') as f:
            for chunk in iter(lambda: f.read(1 << 20), b''):
                sha.update(chunk)
        if not sha.hexdigest().startswith(suffix):
            raise ValueError(f'hash mismatch for {local}: expected prefix '
                             f'{suffix}, got {sha.hexdigest()[:8]}')
    return local
