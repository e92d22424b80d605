"""Shell: base network + head networks (port of
``openpifpaf_tpu/models/shell.py``)."""

import torch
from torch import nn


class Shell(nn.Module):
    """Takes NHWC float images (B, H, W, 3), as the JAX Shell does, runs
    the backbone NCHW in ``channels_last`` and returns one (B, F, C, H', W')
    field tensor per head."""

    def __init__(self, base_net, head_nets):
        super().__init__()
        self.base_net = base_net
        self.head_nets = nn.ModuleList(head_nets)

    @property
    def head_metas(self):
        return [hn.meta for hn in self.head_nets]

    def forward(self, image_batch):
        x = image_batch.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        x = self.base_net(x)
        return tuple(hn(x) for hn in self.head_nets)


def assign_strides(head_metas, base_stride: int):
    """Set head_index and base_stride on metas."""
    for i, meta in enumerate(head_metas):
        meta.head_index = i
        meta.base_stride = base_stride
    return head_metas
