"""Shell: base network + head networks (port of
``openpifpaf_tpu/models/shell.py``)."""

import torch
from torch import nn


class Shell(nn.Module):
    """Takes NHWC float images (B, H, W, 3), as the JAX Shell does, runs
    the backbone NCHW in ``channels_last`` and returns one (B, F, C, H', W')
    field tensor per head.

    ``forward(images, *, train=False, head_mask=None, bn_train=None)``
    follows the JAX Shell: ``train`` puts the heads (raw outputs, dropout)
    and the backbone's BatchNorm in train mode, ``bn_train`` overrides the
    mode of the backbone's BatchNorm only (``--fix-batch-norm``), and a
    head whose ``head_mask`` entry is False returns None. ``generator``
    draws the heads' dropout; ``remat`` recomputes the backbone's blocks
    in the backward pass.
    """

    def __init__(self, base_net, head_nets):
        super().__init__()
        self.base_net = base_net
        self.head_nets = nn.ModuleList(head_nets)

    @property
    def head_metas(self):
        return [hn.meta for hn in self.head_nets]

    def forward(self, image_batch, *, train=False, head_mask=None,
                bn_train=None, generator=None, remat=False):
        x = self.backbone(image_batch,
                          train if bn_train is None else bn_train,
                          remat=remat)
        return self.heads(x, train=train, head_mask=head_mask,
                          generator=generator)

    def backbone(self, image_batch, train=False, *, remat=False):
        """Backbone features (channels_last NCHW) of NHWC images; the
        backbone is called as ``base_net(x, train, remat=remat)``."""
        x = image_batch.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        return self.base_net(x, train, remat=remat)

    def heads(self, features, *, train=False, head_mask=None,
              generator=None):
        """Each head on the backbone's features (None where masked)."""
        if head_mask is None:
            head_mask = [True] * len(self.head_nets)
        return tuple(hn(features, train, generator) if m else None
                     for hn, m in zip(self.head_nets, head_mask))


def assign_strides(head_metas, base_stride: int):
    """Set head_index and base_stride on metas."""
    for i, meta in enumerate(head_metas):
        meta.head_index = i
        meta.base_stride = base_stride
    return head_metas
