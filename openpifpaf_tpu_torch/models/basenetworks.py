"""Backbones (port of ``openpifpaf_tpu/models/basenetworks.py``):
``ConvNormAct``, ``channel_interleave2``, ``InvertedResidualK`` and
``ShuffleNetV2K``; ``Bottleneck``, ``BasicBlock`` and ``Resnet`` (with
ResNeXt's groups); ``InvertedResidualV2`` and ``MobileNetV2``;
``hard_swish``, ``make_divisible``, ``SqueezeExcite``,
``InvertedResidualV3`` and ``MobileNetV3``; ``Fire`` and ``SqueezeNet``.

NCHW modules meant to run in ``torch.channels_last``; BatchNorm with the
reference's model defaults (eps 1e-3, momentum 0.01) and flax's training
rule (:class:`BatchNorm`), or flax's GroupNorm (:class:`GroupNorm`: eps
1e-6, the variance as E[x^2] - E[x]^2); ReLU or leaky ReLU (slope 0.01).
The ShuffleNetV2K is a ShuffleNetV2 with kernel 5 in stages 2-4, no
max-pool (stride 16) and a 1x1 conv5, with the flax model's options: a
dilated stage 4, a second input conv, two blocks in place of conv5, and
group or instance norm. Every backbone is called as ``base_net(x, train,
remat=False)`` and has the ``stride`` and ``out_features`` of its flax
counterpart.
"""

from typing import Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F
import torch.utils.checkpoint

from ..parallel.batch_norm import cross_rank_batch_norm

BN_EPS = 1e-3
BN_MOMENTUM = 0.01
#: flax's ``nn.GroupNorm`` default (torch's is 1e-5)
GN_EPS = 1e-6
NORMS = ('batch', 'group', 'instance')
NON_LINEARITIES = ('relu', 'leaky_relu', 'relu6', 'hard_swish')


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
    in float32 and cast back. With a ``process_group`` (a data-parallel
    step, :func:`set_batch_norm_group`) the statistics are those of every
    rank's batch (:func:`cross_rank_batch_norm`).
    """

    batch_stats = None
    process_group = None

    def forward(self, x, train=False):
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        dtype = x.dtype
        # flax's force_float32_reductions: at least float32
        xf = x.to(torch.promote_types(dtype, torch.float32))
        if self.process_group is not None:
            y, mean, var = cross_rank_batch_norm(
                xf, self.weight, self.bias, self.eps, self.process_group)
            self.batch_stats = (mean.detach(), var.detach())
            return y.to(dtype)
        with torch.no_grad():
            mean = xf.mean((0, 2, 3))
            var = (xf * xf).mean((0, 2, 3)) - mean * mean
            self.batch_stats = (mean, var.clamp_(min=0.0))
        y = F.batch_norm(xf, None, None, self.weight, self.bias, True, 0.0,
                         self.eps)
        return y.to(dtype)


def _group_norm_groups(features):
    """Reference's GroupNorm group count rule (basenetworks.py:398-400)."""
    return (32 if features % 32 == 0 else 29) if features > 100 else 4


class GroupNorm(nn.GroupNorm):
    """flax's ``nn.GroupNorm``: statistics over each group's channels and
    the image in at least float32, the variance as E[x^2] - E[x]^2 clipped
    at 0, epsilon 1e-6. No running statistics, so ``train`` changes
    nothing; instance norm is one channel per group."""

    def __init__(self, num_groups, num_channels):
        super().__init__(num_groups, num_channels, eps=GN_EPS)

    def forward(self, x, train=False):
        dtype = x.dtype
        b, c, h, w = x.shape
        g = self.num_groups
        xf = x.to(torch.promote_types(dtype, torch.float32)).reshape(
            b, g, c // g, h, w)
        mean = xf.mean((2, 3, 4), keepdim=True)
        var = ((xf * xf).mean((2, 3, 4), keepdim=True)
               - mean * mean).clamp(min=0.0)
        scale = self.weight.reshape(1, g, c // g, 1, 1)
        bias = self.bias.reshape(1, g, c // g, 1, 1)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * scale) + bias
        return y.reshape(b, c, h, w).to(dtype).contiguous(
            memory_format=torch.channels_last)


def norm_layer(norm, features):
    """The ``norm`` ('batch', 'group' or 'instance') of ``features``
    channels, as ``ConvNormAct`` of the flax package builds it."""
    if norm == 'batch':
        return BatchNorm(features, eps=BN_EPS, momentum=BN_MOMENTUM)
    if norm == 'group':
        return GroupNorm(_group_norm_groups(features), features)
    if norm == 'instance':
        return GroupNorm(features, features)
    raise ValueError(f'unknown norm {norm!r}; one of {NORMS}')


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


def set_batch_norm_group(model, group):
    """Normalise every :class:`BatchNorm` of ``model`` in train mode over
    the batches of the ranks of ``group`` (None: this process's batch)."""
    for module in model.modules():
        if isinstance(module, BatchNorm):
            module.process_group = group


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


def hard_swish(x):
    return x * F.relu6(x + 3.0) / 6.0


def activation(x, non_linearity):
    """ReLU, leaky ReLU (slope 0.01, flax's default), ReLU6 or hard
    swish."""
    if non_linearity == 'leaky_relu':
        return F.leaky_relu(x, 0.01)
    if non_linearity == 'relu6':
        return F.relu6(x)
    if non_linearity == 'hard_swish':
        return hard_swish(x)
    return F.relu(x)


class ConvNormAct(nn.Module):
    """Convolution without bias, a norm (:func:`norm_layer`), optional
    activation. The flax MobileNets apply ReLU6 or hard swish after a
    ``ConvNormAct(act=False)``; here that is ``non_linearity``."""

    def __init__(self, in_features, features, kernel=3, stride=1, groups=1,
                 dilation=1, act=True, norm='batch', non_linearity='relu'):
        super().__init__()
        if non_linearity not in NON_LINEARITIES:
            raise ValueError(f'unknown non_linearity {non_linearity!r}')
        pad = (kernel - 1) // 2 * dilation
        self.conv = nn.Conv2d(in_features, features, kernel, stride=stride,
                              padding=pad, dilation=dilation, groups=groups,
                              bias=False)
        self.norm = norm_layer(norm, features)
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
                 stride=1, dilation=1, kernel=5, norm='batch',
                 non_linearity='relu'):
        super().__init__()
        branch_features = out_features // 2
        self.first_in_stage = first_in_stage
        style = dict(norm=norm, non_linearity=non_linearity)
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


class Backbone(nn.Module):
    """A backbone as a sequence of modules ``m(x, train)``
    (:meth:`_stages`)."""

    def _stages(self):
        raise NotImplementedError

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


class ShuffleNetV2K(Backbone):
    """ShuffleNetV2 with k=5 kernels in the stages, stride 16, 1x1 conv5.

    Options, as the flax model has them: ``stage4_dilation`` (stage 4 at
    stride 1 with dilated kernels when not 1), ``input_conv2_stride`` and
    ``input_conv2_outchannels`` (a second 3x3 input conv), ``conv5_as_stage``
    (two blocks in place of the 1x1 conv5), ``norm`` ('batch', 'group' or
    'instance') and ``non_linearity``.
    """

    def __init__(self, stages_repeats: Sequence[int],
                 stages_out_channels: Sequence[int], *, kernel=5,
                 stage4_dilation=1, input_conv2_stride=0,
                 input_conv2_outchannels: Optional[int] = None,
                 conv5_as_stage=False, norm='batch', non_linearity='relu'):
        super().__init__()
        self.stages_repeats = list(stages_repeats)
        self.stages_out_channels = list(stages_out_channels)
        self.kernel = kernel
        self.stage4_dilation = stage4_dilation
        self.input_conv2_stride = input_conv2_stride
        self.conv5_as_stage = conv5_as_stage
        self.norm = norm
        self.non_linearity = non_linearity
        style = dict(norm=norm, non_linearity=non_linearity)
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


class Bottleneck(nn.Module):
    """ResNet v1 bottleneck block (torchvision layout): 1x1, 3x3 (ResNeXt
    ``groups``), 1x1 to ``features``, and a 1x1 projection of the input
    when ``project``. Inner width ``features // 4 * width_per_group // 64
    * groups``, as the flax block computes it."""

    def __init__(self, in_features, features, *, stride=1, dilation=1,
                 project=False, groups=1, width_per_group=64):
        super().__init__()
        width = (features // 4) * width_per_group // 64 * groups
        self.conv1 = ConvNormAct(in_features, width, 1)
        self.conv2 = ConvNormAct(width, width, 3, stride=stride,
                                 dilation=dilation, groups=groups)
        self.conv3 = ConvNormAct(width, features, 1, act=False)
        self.projection = ConvNormAct(
            in_features, features, 1, stride=stride, act=False) \
            if project else None

    def forward(self, x, train=False):
        y = self.conv3(self.conv2(self.conv1(x, train), train), train)
        residual = x if self.projection is None else \
            self.projection(x, train)
        return F.relu(residual + y)


class BasicBlock(nn.Module):
    """ResNet v1 basic block (two 3x3 convs, torchvision layout), used by
    resnet18."""

    def __init__(self, in_features, features, *, stride=1, dilation=1,
                 project=False):
        super().__init__()
        self.conv1 = ConvNormAct(in_features, features, 3, stride=stride,
                                 dilation=dilation)
        self.conv2 = ConvNormAct(features, features, 3, dilation=dilation,
                                 act=False)
        self.projection = ConvNormAct(
            in_features, features, 1, stride=stride, act=False) \
            if project else None

    def forward(self, x, train=False):
        y = self.conv2(self.conv1(x, train), train)
        residual = x if self.projection is None else \
            self.projection(x, train)
        return F.relu(residual + y)


class ResnetStem(nn.Module):
    """7x7 input conv, BatchNorm, ReLU and, when ``pool0_stride``, a 3x3
    max pool padded by 1 (with -inf, as flax's explicit padding)."""

    def __init__(self, input_conv_stride=2, pool0_stride=0):
        super().__init__()
        self.conv = nn.Conv2d(3, 64, 7, stride=input_conv_stride, padding=3,
                              bias=False)
        self.norm = BatchNorm(64, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.pool0_stride = pool0_stride

    def forward(self, x, train=False):
        x = F.relu(self.norm(self.conv(x), train))
        if self.pool0_stride:
            x = F.max_pool2d(x, 3, stride=self.pool0_stride, padding=1)
        return x


class Resnet(Backbone):
    """ResNet with the reference's pose-estimation stride surgery: by
    default the input max pool is removed (``pool0_stride = 0``) so the
    total stride is 16. ``groups`` above 1 makes it a ResNeXt.

    Every stage's first Bottleneck projects its input, stage 0's too (at
    stride 1); a BasicBlock's stage 0 does not.
    """

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 base_features=256, basic_block=False, pool0_stride=0,
                 input_conv_stride=2, input_conv2_stride=0,
                 block5_dilation=1, remove_last_block=False, groups=1,
                 width_per_group=64):
        super().__init__()
        self.layers = list(layers)
        self.base_features = base_features
        self.basic_block = basic_block
        self.pool0_stride = pool0_stride
        self.input_conv_stride = input_conv_stride
        self.input_conv2_stride = input_conv2_stride
        self.block5_dilation = block5_dilation
        self.remove_last_block = remove_last_block
        self.groups = groups
        self.width_per_group = width_per_group

        self.stem = ResnetStem(input_conv_stride, pool0_stride)
        self.input_conv2 = ConvNormAct(64, 64, 3, stride=input_conv2_stride) \
            if input_conv2_stride else None
        in_features = 64
        blocks = []
        for block_i in range(3 if remove_last_block else 4):
            features = base_features * (2 ** block_i)
            is_last = block_i == 3
            dilation = block5_dilation if is_last else 1
            stride = 1 if block_i == 0 or (is_last and dilation != 1) else 2
            for i in range(self.layers[block_i]):
                if basic_block:
                    blocks.append(BasicBlock(
                        in_features, features, stride=stride if i == 0 else 1,
                        dilation=dilation, project=i == 0 and block_i > 0))
                else:
                    blocks.append(Bottleneck(
                        in_features, features, stride=stride if i == 0 else 1,
                        dilation=dilation, project=i == 0, groups=groups,
                        width_per_group=width_per_group))
                in_features = features
        self.blocks = nn.Sequential(*blocks)

    @property
    def stride(self):
        s = 32
        if not self.pool0_stride:
            s //= 2
        elif self.pool0_stride != 2:
            s = int(s * 2 / self.pool0_stride)
        if self.input_conv_stride != 2:
            s = int(s * 2 / self.input_conv_stride)
        if self.input_conv2_stride:
            s *= 2
        if self.remove_last_block:
            s //= 2
        if self.block5_dilation != 1:
            s //= 2
        return s

    @property
    def out_features(self):
        n_blocks = 3 if self.remove_last_block else 4
        return self.base_features * (2 ** (n_blocks - 1))

    def _stages(self):
        yield self.stem
        if self.input_conv2 is not None:
            yield self.input_conv2
        yield from self.blocks


class InvertedResidualV2(nn.Module):
    """MobileNetV2 inverted residual: expand (1x1, ReLU6, unless the
    ratio is 1), depthwise 3x3 (ReLU6), project (1x1, linear); residual
    at stride 1 with equal widths."""

    def __init__(self, in_features, features, *, stride=1, expand_ratio=6):
        super().__init__()
        hidden = in_features * expand_ratio
        convs = []
        if expand_ratio != 1:
            convs.append(ConvNormAct(in_features, hidden, 1,
                                     non_linearity='relu6'))
        convs += [ConvNormAct(hidden, hidden, 3, stride=stride, groups=hidden,
                              non_linearity='relu6'),
                  ConvNormAct(hidden, features, 1, act=False)]
        self.convs = nn.ModuleList(convs)
        self.residual = stride == 1 and in_features == features

    def forward(self, x, train=False):
        y = _run(self.convs, x, train)
        return x + y if self.residual else y


class MobileNetV2(Backbone):
    """MobileNetV2 backbone, stride 32, out 1280."""

    stride = 32
    out_features = 1280

    # (expand_ratio, features, repeats, stride)
    config = (
        (1, 16, 1, 1),
        (6, 24, 2, 2),
        (6, 32, 3, 2),
        (6, 64, 4, 2),
        (6, 96, 3, 1),
        (6, 160, 3, 2),
        (6, 320, 1, 1),
    )

    def __init__(self):
        super().__init__()
        self.stem = ConvNormAct(3, 32, 3, stride=2, non_linearity='relu6')
        in_features = 32
        blocks = []
        for expand, features, repeats, stride in self.config:
            for i in range(repeats):
                blocks.append(InvertedResidualV2(
                    in_features, features, stride=stride if i == 0 else 1,
                    expand_ratio=expand))
                in_features = features
        self.blocks = nn.Sequential(*blocks)
        self.conv_last = ConvNormAct(in_features, 1280, 1,
                                     non_linearity='relu6')

    def _stages(self):
        yield self.stem
        yield from self.blocks
        yield self.conv_last


def make_divisible(v, divisor=8):
    """torchvision's channel rounding (_make_divisible)."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class SqueezeExcite(nn.Module):
    """Squeeze-excitation: the image mean, a 1x1 conv to
    ``reduce_features`` (ReLU), a 1x1 conv back (hard sigmoid,
    ``relu6(x + 3) / 6``), a product with the input. Both convs have
    biases, as flax's ``nn.Conv`` by default."""

    def __init__(self, features, reduce_features):
        super().__init__()
        self.reduce = nn.Conv2d(features, reduce_features, 1)
        self.expand = nn.Conv2d(reduce_features, features, 1)

    def forward(self, x, train=False):
        s = x.mean((2, 3), keepdim=True)
        s = self.expand(F.relu(self.reduce(s)))
        return x * (F.relu6(s + 3.0) / 6.0)


class InvertedResidualV3(nn.Module):
    """MobileNetV3 block with optional squeeze-excitation."""

    def __init__(self, in_features, features, hidden, *, kernel=3, stride=1,
                 use_se=False, use_hs=False):
        super().__init__()
        act = 'hard_swish' if use_hs else 'relu'
        convs = []
        if hidden != in_features:
            convs.append(ConvNormAct(in_features, hidden, 1,
                                     non_linearity=act))
        convs.append(ConvNormAct(hidden, hidden, kernel, stride=stride,
                                 groups=hidden, non_linearity=act))
        self.convs = nn.ModuleList(convs)
        # torchvision rounds the reduction to a multiple of 8
        self.se = SqueezeExcite(hidden, make_divisible(hidden // 4, 8)) \
            if use_se else None
        self.project = ConvNormAct(hidden, features, 1, act=False)
        self.residual = stride == 1 and in_features == features

    def forward(self, x, train=False):
        y = _run(self.convs, x, train)
        if self.se is not None:
            y = self.se(y)
        y = self.project(y, train)
        return x + y if self.residual else y


class MobileNetV3(Backbone):
    """MobileNetV3 backbone with the reference's stride surgery: the input
    conv has stride 1, so the total stride is 16."""

    # (kernel, hidden, features, use_se, use_hs, stride)
    config_large = (
        (3, 16, 16, False, False, 1),
        (3, 64, 24, False, False, 2),
        (3, 72, 24, False, False, 1),
        (5, 72, 40, True, False, 2),
        (5, 120, 40, True, False, 1),
        (5, 120, 40, True, False, 1),
        (3, 240, 80, False, True, 2),
        (3, 200, 80, False, True, 1),
        (3, 184, 80, False, True, 1),
        (3, 184, 80, False, True, 1),
        (3, 480, 112, True, True, 1),
        (3, 672, 112, True, True, 1),
        (5, 672, 160, True, True, 2),
        (5, 960, 160, True, True, 1),
        (5, 960, 160, True, True, 1),
    )
    config_small = (
        (3, 16, 16, True, False, 2),
        (3, 72, 24, False, False, 2),
        (3, 88, 24, False, False, 1),
        (5, 96, 40, True, True, 2),
        (5, 240, 40, True, True, 1),
        (5, 240, 40, True, True, 1),
        (5, 120, 48, True, True, 1),
        (5, 144, 48, True, True, 1),
        (5, 288, 96, True, True, 2),
        (5, 576, 96, True, True, 1),
        (5, 576, 96, True, True, 1),
    )

    stride = 16

    def __init__(self, variant='large'):
        super().__init__()
        if variant not in ('large', 'small'):
            raise ValueError(f'unknown MobileNetV3 variant {variant!r}')
        self.variant = variant
        self.stem = ConvNormAct(3, 16, 3, stride=1,
                                non_linearity='hard_swish')
        in_features = 16
        blocks = []
        config = self.config_large if variant == 'large' \
            else self.config_small
        for kernel, hidden, features, use_se, use_hs, stride in config:
            blocks.append(InvertedResidualV3(
                in_features, features, hidden, kernel=kernel, stride=stride,
                use_se=use_se, use_hs=use_hs))
            in_features = features
        self.blocks = nn.Sequential(*blocks)
        self.conv_last = ConvNormAct(in_features, self.out_features, 1,
                                     non_linearity='hard_swish')

    @property
    def out_features(self):
        return 960 if self.variant == 'large' else 576

    def _stages(self):
        yield self.stem
        yield from self.blocks
        yield self.conv_last


def _max_pool(x):
    """3x3 max pool, stride 2, padded by 1, floor mode (the flax model's
    explicit padding, not torchvision's ``ceil_mode=True``)."""
    return F.max_pool2d(x, 3, stride=2, padding=1)


class Fire(nn.Module):
    """SqueezeNet's Fire module (biased convs, ReLU): a 1x1 squeeze, then a
    1x1 and a 3x3 expand, concatenated; ``pool_before`` runs the 3x3 max
    pool that the flax model has in front of it."""

    def __init__(self, in_features, squeeze_features, expand_features, *,
                 pool_before=False):
        super().__init__()
        self.squeeze = nn.Conv2d(in_features, squeeze_features, 1)
        self.expand1 = nn.Conv2d(squeeze_features, expand_features, 1)
        self.expand3 = nn.Conv2d(squeeze_features, expand_features, 3,
                                 padding=1)
        self.pool_before = pool_before

    def forward(self, x, train=False):
        if self.pool_before:
            x = _max_pool(x)
        s = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1(s)), F.relu(self.expand3(s))],
                         dim=1)


class SqueezeNetStem(nn.Module):
    """3x3 biased conv with stride 2 (ReLU), then the first max pool."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 64, 3, stride=2, padding=1)

    def forward(self, x, train=False):
        return _max_pool(F.relu(self.conv(x)))


class SqueezeNet(Backbone):
    """SqueezeNet 1.1 backbone with the reference's padding adjustments:
    stride 16, out 512."""

    stride = 16
    out_features = 512

    # (squeeze, expand, a max pool in front)
    config = ((16, 64, False), (16, 64, False), (32, 128, True),
              (32, 128, False), (48, 192, True), (48, 192, False),
              (64, 256, False), (64, 256, False))

    def __init__(self):
        super().__init__()
        self.stem = SqueezeNetStem()
        in_features = 64
        fires = []
        for squeeze, expand, pool in self.config:
            fires.append(Fire(in_features, squeeze, expand, pool_before=pool))
            in_features = 2 * expand
        self.fires = nn.Sequential(*fires)

    def _stages(self):
        yield self.stem
        yield from self.fires
