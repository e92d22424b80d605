"""Composite-field heads (port of ``openpifpaf_tpu/models/heads.py``:
``CompositeField4``, ``pixel_shuffle``, ``index_field`` and the
test-time flips ``pif_hflip`` and ``paf_hflip``).

Optional dropout on the features (``dropout_p``, in train mode only);
one 1x1 convolution produces ``n_fields * n_components * u^2`` channels,
in the JAX order ``f * n_components + c``; optional PixelShuffle
upsampling with a symmetric crop. In train mode the raw (B, F, C, H, W)
tensor is returned, for the loss; otherwise the inference
post-processing runs in the forward: sigmoid on confidences, the
coordinate index added to the regressions, softplus on the scales
(``postprocess``, which the spatial forward also runs on each shard). The
output is (B, F, C, H, W), as in the JAX package.
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


def dropout(x, p, generator=None):
    """flax's ``nn.Dropout``: keep each element with probability 1 - p and
    scale the kept ones by 1 / (1 - p); the draws come from
    ``generator`` (a ``torch.Generator`` on ``x``'s device)."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


class CompositeField4(nn.Module):
    def __init__(self, meta, in_features, dropout_p=0.0):
        super().__init__()
        self.meta = meta
        self.dropout_p = dropout_p
        upsample = meta.upsample_stride
        self.conv = nn.Conv2d(
            in_features, meta.n_fields * meta.n_components * upsample ** 2,
            1)

    def forward(self, x, train=False, generator=None):
        meta = self.meta
        n_components = meta.n_components
        upsample = meta.upsample_stride

        if train and self.dropout_p > 0.0:
            x = dropout(x, self.dropout_p, generator)
        x = self.conv(x)
        if upsample > 1:
            x = pixel_shuffle(x, upsample)
            low_cut = (upsample - 1) // 2
            high_cut = math.ceil((upsample - 1) / 2.0)
            x = x[:, :, low_cut:x.shape[2] - high_cut,
                  low_cut:x.shape[3] - high_cut]

        batch, _, height, width = x.shape
        x = x.reshape(batch, meta.n_fields, n_components, height, width)
        if train:
            return x
        return postprocess(x, meta)


def postprocess(x, meta, row0=0):
    """The inference post-processing of raw (B, F, C, H, W) fields:
    sigmoid on the confidences, the coordinate index added to the
    regressions that ``meta.vector_offsets`` marks, softplus on the
    scales. ``row0`` is the global row of ``x``'s first row (a shard of
    the fields' height)."""
    nc = meta.n_confidences
    nv = meta.n_vectors
    ns = meta.n_scales
    parts = [x[:, :, 0:1], torch.sigmoid(x[:, :, 1:1 + nc])]
    if nv > 0:
        idx = index_field((x.shape[3], x.shape[4]), device=x.device)
        if row0:
            idx[1] += row0
        idx = idx[None, None]
        for i, do_offset in enumerate(meta.vector_offsets):
            reg = x[:, :, 1 + nc + 2 * i:1 + nc + 2 * i + 2]
            parts.append(reg + idx if do_offset else reg)
    if ns > 0:
        parts.append(F.softplus(
            x[:, :, 1 + nc + 2 * nv:1 + nc + 2 * nv + ns]))
    return torch.cat(parts, dim=2)


def pif_hflip(fields, keypoints, hflip):
    """Horizontal test-time flip of CIF fields (B, F, C, H, W) with the
    channel layout [logb, conf, x, y, scale]: left/right keypoint fields
    swapped, the W axis reversed, the x regression negated."""
    flip_indices = [keypoints.index(hflip[kp]) if kp in hflip else i
                    for i, kp in enumerate(keypoints)]
    out = fields[:, flip_indices].flip(-1)
    out[:, :, 2] *= -1.0
    return out


def paf_hflip(fields, keypoints, skeleton, hflip):
    """Horizontal test-time flip of CAF fields (B, F, C, H, W) with the
    layout [logb, conf, x1, y1, x2, y2, s1, s2]: each edge takes its
    mirror edge's field, the W axis reversed, both x regressions negated;
    an edge whose mirror runs the other way swaps (x1, y1, s1) with
    (x2, y2, s2)."""
    names = [(keypoints[a - 1], keypoints[b - 1]) for a, b in skeleton]
    flipped = [(hflip.get(a, a), hflip.get(b, b)) for a, b in names]
    flip_indices = list(range(len(skeleton)))
    reverse = []
    for i, (a, b) in enumerate(names):
        if (a, b) in flipped:
            flip_indices[i] = flipped.index((a, b))
        if (b, a) in flipped:
            flip_indices[i] = flipped.index((b, a))
            reverse.append(i)
    out = fields[:, flip_indices].flip(-1)
    out[:, :, 2] *= -1.0
    out[:, :, 4] *= -1.0
    if reverse:
        swap = list(range(out.shape[2]))
        swap[2:8] = [4, 5, 2, 3, 7, 6]
        out[:, reverse] = out[:, reverse][:, :, swap]
    return out
