"""ShuffleNetV2K backbone (port of ``openpifpaf_tpu/models/basenetworks.py``:
``ConvNormAct``, ``channel_interleave2``, ``InvertedResidualK`` and
``ShuffleNetV2K``).

NCHW modules meant to run in ``torch.channels_last``; BatchNorm with the
reference's model defaults (eps 1e-3, momentum 0.01), ReLU. A
ShuffleNetV2 with kernel 5 in stages 2-4, no max-pool (stride 16) and a
1x1 conv5.
"""

import torch
from torch import nn
import torch.nn.functional as F

BN_EPS = 1e-3
BN_MOMENTUM = 0.01


class ConvNormAct(nn.Module):
    """Convolution without bias, BatchNorm, optional ReLU."""

    def __init__(self, in_features, features, kernel=3, stride=1, groups=1,
                 dilation=1, act=True):
        super().__init__()
        pad = (kernel - 1) // 2 * dilation
        self.conv = nn.Conv2d(in_features, features, kernel, stride=stride,
                              padding=pad, dilation=dilation, groups=groups,
                              bias=False)
        self.norm = nn.BatchNorm2d(features, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = act

    def forward(self, x):
        x = self.norm(self.conv(x))
        return F.relu(x) if self.act else x


def channel_interleave2(a, b):
    """``channel_shuffle(cat([a, b], 1), 2)`` as one interleave:
    out[:, 2i] = a[:, i] and out[:, 2i + 1] = b[:, i]."""
    bb, m, h, w = a.shape
    return torch.stack([a, b], dim=2).reshape(bb, 2 * m, h, w)


class InvertedResidualK(nn.Module):
    """ShuffleNetV2 inverted residual with a configurable kernel size.

    The first block of a stage has two branches on the full input; the
    others split the input in halves and transform only the second.
    """

    def __init__(self, in_features, out_features, first_in_stage, *,
                 stride=1, dilation=1, kernel=5):
        super().__init__()
        branch_features = out_features // 2
        self.first_in_stage = first_in_stage
        if first_in_stage:
            self.branch1 = nn.Sequential(
                ConvNormAct(in_features, in_features, kernel, stride=stride,
                            dilation=dilation, groups=in_features, act=False),
                ConvNormAct(in_features, branch_features, 1),
            )
            branch2_in = in_features
        else:
            self.branch1 = None
            branch2_in = branch_features
        self.branch2 = nn.Sequential(
            ConvNormAct(branch2_in, branch_features, 1),
            ConvNormAct(branch_features, branch_features, kernel,
                        stride=stride, dilation=dilation,
                        groups=branch_features, act=False),
            ConvNormAct(branch_features, branch_features, 1),
        )

    def forward(self, x):
        if self.branch1 is None:
            x1, x2 = x.chunk(2, dim=1)
            return channel_interleave2(x1, self.branch2(x2))
        return channel_interleave2(self.branch1(x), self.branch2(x))


class ShuffleNetV2K(nn.Module):
    """ShuffleNetV2 with k=5 kernels in the stages, stride 16, 1x1 conv5."""

    stride = 16

    def __init__(self, stages_repeats, stages_out_channels, *, kernel=5):
        super().__init__()
        self.stages_repeats = list(stages_repeats)
        self.stages_out_channels = list(stages_out_channels)
        channels = self.stages_out_channels
        self.input_block = ConvNormAct(3, channels[0], 3, stride=2)
        blocks = []
        in_features = channels[0]
        for repeats, out_features in zip(self.stages_repeats, channels[1:4]):
            blocks.append(InvertedResidualK(in_features, out_features, True,
                                            stride=2, kernel=kernel))
            blocks.extend(
                InvertedResidualK(out_features, out_features, False,
                                  kernel=kernel)
                for _ in range(repeats - 1))
            in_features = out_features
        self.blocks = nn.Sequential(*blocks)
        self.conv5 = ConvNormAct(in_features, channels[-1], 1)

    @property
    def out_features(self):
        return self.stages_out_channels[-1]

    def forward(self, x):
        return self.conv5(self.blocks(self.input_block(x)))
