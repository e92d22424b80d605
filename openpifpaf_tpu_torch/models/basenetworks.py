"""ShuffleNetV2K backbone (port of ``openpifpaf_tpu/models/basenetworks.py``:
``ConvNormAct``, ``channel_interleave2``, ``InvertedResidualK`` and
``ShuffleNetV2K``).

NCHW modules meant to run in ``torch.channels_last``; BatchNorm with the
reference's model defaults (eps 1e-3, momentum 0.01) and flax's training
rule (:class:`BatchNorm`), ReLU or leaky ReLU (slope 0.01). A ShuffleNetV2 with kernel 5 in stages 2-4, no max-pool
(stride 16) and a 1x1 conv5, with the flax model's options: a dilated
stage 4, a second input conv and two blocks in place of conv5.
"""

from typing import Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F
import torch.utils.checkpoint

BN_EPS = 1e-3
BN_MOMENTUM = 0.01
NON_LINEARITIES = ('relu', 'leaky_relu')


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d with the flax training rule and the mode as an argument.

    ``forward(x, train)``, like flax's ``use_running_average=not train``
    (the module's ``training`` flag is not read). In train mode it
    normalises with the batch statistics and keeps them, in float32 and
    detached, in ``batch_stats``: the mean and the *biased* variance
    E[x^2] - E[x]^2 as flax computes them (torch's own update would use
    the unbiased variance). :func:`commit_batch_stats` folds them into
    the running buffers with flax's rule after the step, so that a
    recomputed forward (``remat``) or a validation pass does not move
    them. In train mode, input narrower than float32 (bf16) is normalised
    in float32 and cast back.
    """

    batch_stats = None

    def forward(self, x, train=False):
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        dtype = x.dtype
        # flax's force_float32_reductions: at least float32
        xf = x.to(torch.promote_types(dtype, torch.float32))
        with torch.no_grad():
            mean = xf.mean((0, 2, 3))
            var = (xf * xf).mean((0, 2, 3)) - mean * mean
            self.batch_stats = (mean, var.clamp_(min=0.0))
        y = F.batch_norm(xf, None, None, self.weight, self.bias, True, 0.0,
                         self.eps)
        return y.to(dtype)


def commit_batch_stats(model, momentum=BN_MOMENTUM):
    """Fold each :class:`BatchNorm`'s kept batch statistics into its
    running buffers as flax does, ``ra = (1 - m) * ra + m * batch``, and
    clear them; returns the number of modules updated."""
    n = 0
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, BatchNorm) and module.batch_stats is not None:
                mean, var = module.batch_stats
                module.running_mean.mul_(1.0 - momentum).add_(momentum * mean)
                module.running_var.mul_(1.0 - momentum).add_(momentum * var)
                module.batch_stats = None
                n += 1
    return n


def discard_batch_stats(model):
    """Drop the kept batch statistics (a validation pass, a step that
    runs BatchNorm on its running statistics)."""
    for module in model.modules():
        if isinstance(module, BatchNorm):
            module.batch_stats = None


def _run(modules, x, train):
    for module in modules:
        x = module(x, train)
    return x


def activation(x, non_linearity):
    """ReLU or leaky ReLU (slope 0.01, flax's default)."""
    if non_linearity == 'leaky_relu':
        return F.leaky_relu(x, 0.01)
    return F.relu(x)


class ConvNormAct(nn.Module):
    """Convolution without bias, BatchNorm, optional activation."""

    def __init__(self, in_features, features, kernel=3, stride=1, groups=1,
                 dilation=1, act=True, non_linearity='relu'):
        super().__init__()
        if non_linearity not in NON_LINEARITIES:
            raise ValueError(f'unknown non_linearity {non_linearity!r}')
        pad = (kernel - 1) // 2 * dilation
        self.conv = nn.Conv2d(in_features, features, kernel, stride=stride,
                              padding=pad, dilation=dilation, groups=groups,
                              bias=False)
        self.norm = BatchNorm(features, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = act
        self.non_linearity = non_linearity

    def forward(self, x, train=False):
        x = self.norm(self.conv(x), train)
        return activation(x, self.non_linearity) if self.act else x


def channel_interleave2(a, b):
    """``channel_shuffle(cat([a, b], 1), 2)`` as one interleave:
    out[:, 2i] = a[:, i] and out[:, 2i + 1] = b[:, i]. The result is
    channels_last, whatever the inputs' memory format."""
    bb, m, h, w = a.shape
    out = torch.stack([a.permute(0, 2, 3, 1), b.permute(0, 2, 3, 1)], dim=-1)
    return out.reshape(bb, h, w, 2 * m).permute(0, 3, 1, 2)


class InvertedResidualK(nn.Module):
    """ShuffleNetV2 inverted residual with a configurable kernel size.

    The first block of a stage has two branches on the full input; the
    others split the input in halves and transform only the second.
    """

    def __init__(self, in_features, out_features, first_in_stage, *,
                 stride=1, dilation=1, kernel=5, non_linearity='relu'):
        super().__init__()
        branch_features = out_features // 2
        self.first_in_stage = first_in_stage
        style = dict(non_linearity=non_linearity)
        if first_in_stage:
            self.branch1 = nn.Sequential(
                ConvNormAct(in_features, in_features, kernel, stride=stride,
                            dilation=dilation, groups=in_features, act=False,
                            **style),
                ConvNormAct(in_features, branch_features, 1, **style),
            )
            branch2_in = in_features
        else:
            self.branch1 = None
            branch2_in = branch_features
        self.branch2 = nn.Sequential(
            ConvNormAct(branch2_in, branch_features, 1, **style),
            ConvNormAct(branch_features, branch_features, kernel,
                        stride=stride, dilation=dilation,
                        groups=branch_features, act=False, **style),
            ConvNormAct(branch_features, branch_features, 1, **style),
        )

    def forward(self, x, train=False):
        if self.branch1 is None:
            x1, x2 = x.chunk(2, dim=1)
            return channel_interleave2(x1, _run(self.branch2, x2, train))
        return channel_interleave2(_run(self.branch1, x, train),
                                   _run(self.branch2, x, train))


class ShuffleNetV2K(nn.Module):
    """ShuffleNetV2 with k=5 kernels in the stages, stride 16, 1x1 conv5.

    Options, as the flax model has them: ``stage4_dilation`` (stage 4 at
    stride 1 with dilated kernels when not 1), ``input_conv2_stride`` and
    ``input_conv2_outchannels`` (a second 3x3 input conv), ``conv5_as_stage``
    (two blocks in place of the 1x1 conv5) and ``non_linearity``.
    """

    def __init__(self, stages_repeats: Sequence[int],
                 stages_out_channels: Sequence[int], *, kernel=5,
                 stage4_dilation=1, input_conv2_stride=0,
                 input_conv2_outchannels: Optional[int] = None,
                 conv5_as_stage=False, non_linearity='relu'):
        super().__init__()
        self.stages_repeats = list(stages_repeats)
        self.stages_out_channels = list(stages_out_channels)
        self.kernel = kernel
        self.stage4_dilation = stage4_dilation
        self.input_conv2_stride = input_conv2_stride
        self.conv5_as_stage = conv5_as_stage
        self.non_linearity = non_linearity
        style = dict(non_linearity=non_linearity)
        channels = self.stages_out_channels
        self.input_block = ConvNormAct(3, channels[0], 3, stride=2, **style)
        in_features = channels[0]
        self.input_conv2 = None
        if input_conv2_stride:
            out = input_conv2_outchannels or in_features
            self.input_conv2 = ConvNormAct(in_features, out, 3,
                                           stride=input_conv2_stride,
                                           **style)
            in_features = out

        blocks = []
        for repeats, out_features, dilation in zip(
                self.stages_repeats, channels[1:4], [1, 1, stage4_dilation]):
            stage_stride = 2 if dilation == 1 else 1
            blocks.append(InvertedResidualK(
                in_features, out_features, True, stride=stage_stride,
                dilation=dilation, kernel=kernel, **style))
            blocks.extend(
                InvertedResidualK(out_features, out_features, False,
                                  dilation=dilation, kernel=kernel, **style)
                for _ in range(repeats - 1))
            in_features = out_features
        self.blocks = nn.Sequential(*blocks)

        out_features = channels[-1]
        if conv5_as_stage:
            # two blocks cost about the parameters of the 1x1 conv
            self.conv5 = nn.Sequential(
                InvertedResidualK(in_features, out_features,
                                  in_features != out_features,
                                  dilation=stage4_dilation, kernel=kernel,
                                  **style),
                InvertedResidualK(out_features, out_features, False,
                                  dilation=stage4_dilation, kernel=kernel,
                                  **style))
        else:
            self.conv5 = ConvNormAct(in_features, out_features, 1, **style)

    @property
    def stride(self):
        s = 16
        if self.input_conv2_stride:
            s *= 2
        if self.stage4_dilation != 1:
            s //= 2
        return s

    @property
    def out_features(self):
        return self.stages_out_channels[-1]

    def _stages(self):
        """The backbone as a sequence of modules ``m(x, train)``."""
        yield self.input_block
        if self.input_conv2 is not None:
            yield self.input_conv2
        yield from self.blocks
        if isinstance(self.conv5, nn.Sequential):
            yield from self.conv5
        else:
            yield self.conv5

    def forward(self, x, train=False, remat=False):
        """``remat`` keeps only each block's input and recomputes the
        block in the backward pass (``torch.utils.checkpoint``), trading
        about one forward of compute for most of the activation memory."""
        for module in self._stages():
            if remat and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(
                    module, x, train, use_reentrant=False)
            else:
                x = module(x, train)
        return x
