"""Composite-field heads (port of ``openpifpaf_tpu/models/heads.py``:
``CompositeField4``, ``pixel_shuffle`` and ``index_field``).

One 1x1 convolution produces ``n_fields * n_components * u^2`` channels,
in the JAX order ``f * n_components + c``; optional PixelShuffle
upsampling with a symmetric crop; then the inference post-processing
runs in the forward: sigmoid on confidences, the coordinate index added
to the regressions, softplus on the scales. The output is
(B, F, C, H, W), as in the JAX package.
"""

import math

import torch
from torch import nn
import torch.nn.functional as F


def pixel_shuffle(x, upscale: int):
    """NCHW PixelShuffle: in-channel ``c * u^2 + i * u + j`` goes to
    (h * u + i, w * u + j, c), the channel order of the JAX version."""
    return F.pixel_shuffle(x, upscale)


def index_field(shape, device=None):
    """(2, H, W) coordinate grid: channel 0 = x (column), 1 = y (row)."""
    h, w = shape
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    return torch.stack([xs.expand(h, w), ys.expand(h, w)])


class CompositeField4(nn.Module):
    def __init__(self, meta, in_features):
        super().__init__()
        self.meta = meta
        upsample = meta.upsample_stride
        self.conv = nn.Conv2d(
            in_features, meta.n_fields * meta.n_components * upsample ** 2,
            1)

    def forward(self, x):
        meta = self.meta
        n_components = meta.n_components
        upsample = meta.upsample_stride

        x = self.conv(x)
        if upsample > 1:
            x = pixel_shuffle(x, upsample)
            low_cut = (upsample - 1) // 2
            high_cut = math.ceil((upsample - 1) / 2.0)
            x = x[:, :, low_cut:x.shape[2] - high_cut,
                  low_cut:x.shape[3] - high_cut]

        batch, _, height, width = x.shape
        x = x.reshape(batch, meta.n_fields, n_components, height, width)

        nc = meta.n_confidences
        nv = meta.n_vectors
        ns = meta.n_scales
        parts = [x[:, :, 0:1], torch.sigmoid(x[:, :, 1:1 + nc])]
        if nv > 0:
            idx = index_field((height, width), device=x.device)[None, None]
            for i, do_offset in enumerate(meta.vector_offsets):
                reg = x[:, :, 1 + nc + 2 * i:1 + nc + 2 * i + 2]
                parts.append(reg + idx if do_offset else reg)
        if ns > 0:
            parts.append(F.softplus(
                x[:, :, 1 + nc + 2 * nv:1 + nc + 2 * nv + ns]))
        return torch.cat(parts, dim=2)
