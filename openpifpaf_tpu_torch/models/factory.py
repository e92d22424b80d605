"""Network factory (port of ``openpifpaf_tpu/models/factory.py``:
``BASE_FACTORIES`` for the ShuffleNetV2K family and
``Factory.from_scratch``).

Random initialisation follows flax's defaults, drawn from an explicit
``torch.Generator``: truncated-normal (LeCun) convolution kernels, zero
biases, BatchNorm scale 1, bias 0, running mean 0 and variance 1.
"""

import math
from typing import Optional, Sequence

import torch
from torch import nn

from .. import headmeta
from . import basenetworks, heads
from .shell import Shell, assign_strides


def _snk(repeats, channels):
    return lambda: basenetworks.ShuffleNetV2K(repeats, channels)


BASE_FACTORIES = {
    'shufflenetv2k16': _snk([4, 8, 4], [24, 348, 696, 1392, 1392]),
    'shufflenetv2k20': _snk([5, 10, 5], [32, 512, 1024, 2048, 2048]),
    'shufflenetv2k30': _snk([8, 16, 6], [32, 512, 1024, 2048, 2048]),
    'shufflenetv2k44': _snk([12, 24, 8], [32, 512, 1024, 2048, 2048]),
    'shufflenetv2kx5': _snk([6, 13, 6], [42, 640, 1280, 2560, 2560]),
}

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
            elif isinstance(module, nn.BatchNorm2d):
                module.reset_parameters()
    return model


class Factory:
    base_name: str = 'shufflenetv2k16'

    def __init__(self, base_name: Optional[str] = None,
                 checkpoint: Optional[str] = None):
        if checkpoint is not None:
            raise NotImplementedError(
                'loading a checkpoint is not yet ported to PyTorch '
                '(ROADMAP A11: training/checkpoint.py)')
        if base_name is not None:
            self.base_name = base_name

    def from_scratch(self, head_metas: Sequence[headmeta.Base], *,
                     generator: Optional[torch.Generator] = None,
                     base_net: Optional[nn.Module] = None) -> Shell:
        """Shell with randomly initialised weights. ``base_net`` overrides
        the ``base_name`` backbone (e.g. a narrow ShuffleNetV2K)."""
        if base_net is None:
            if self.base_name not in BASE_FACTORIES:
                raise ValueError(
                    f'unknown or not yet ported base network '
                    f'{self.base_name!r}; available: '
                    f'{sorted(BASE_FACTORIES)}')
            base_net = BASE_FACTORIES[self.base_name]()
        for meta in head_metas:
            if not isinstance(meta, (headmeta.Cif, headmeta.Caf)):
                raise NotImplementedError(
                    f'head {type(meta).__name__} is not yet ported '
                    '(ROADMAP A9/A10)')
        assign_strides(head_metas, base_net.stride)
        head_nets = [heads.CompositeField4(meta, base_net.out_features)
                     for meta in head_metas]
        model = Shell(base_net, head_nets)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_like_flax(model, generator)
        return model.to(memory_format=torch.channels_last)
