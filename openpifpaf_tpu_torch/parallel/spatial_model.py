"""The module graph on an image split along H: the spatial forward of
``models/basenetworks.py`` (ShuffleNetV2K, ResNet) and ``models/heads.py``.

Each function takes ``ms``, the module of every local shard (the same
module, or the replica on each shard's device), and a
:class:`.spatial.Rows`. Every ``Conv2d`` and max pool runs on its shard
through the row plan (:func:`.spatial.row_op`), every BatchNorm through
:func:`.batch_norm.rows_batch_norm`; 1x1 convs, activations, the channel
split, the interleave, residual sums and the heads' pixel shuffle are
row-local.

The forward walks the module list, one handler per module type. A
``__torch_function__`` tensor subclass carrying the shards was the other
way: it would have to give every op a shard's view of a global shape
(``channel_interleave2`` reshapes with the height it reads from its
input) and reproduce BatchNorm's statistics and its cross-rank autograd
function op by op, while the walk states each module's row arithmetic
once, where a reader can check it. A module type without a handler
raises ``ValueError``.
"""

import math

import torch
import torch.nn.functional as F

from ..models import basenetworks, heads
from .batch_norm import rows_batch_norm
from .spatial import RowOp, Rows, gather, row_op


def _sub(ms, name):
    return [getattr(m, name) for m in ms]


def images_to_rows(images, axis):
    """NHWC images (B, H, W, 3) as channels_last NCHW rows of ``axis``."""
    rows = Rows.split(images, axis, dim=1)
    return rows.like([p.permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last) for p in rows.parts], dim=2)


def conv_rows(convs, rows, pad_value=0.0):
    """An ``nn.Conv2d`` on its shard: row-local at 1x1 stride 1, else
    through the row plan (padding along W only, the rows' padding is the
    plan's)."""
    c = convs[0]
    (kh, _), (sh, sw), (ph, pw), (dh, dw) = (c.kernel_size, c.stride,
                                             c.padding, c.dilation)
    if kh == 1 and sh == 1 and ph == 0:
        return rows.map(lambda k, x: convs[k](x))

    def run(k, x):
        m = convs[k]
        return F.conv2d(x.contiguous(memory_format=torch.channels_last),
                        m.weight, m.bias, (sh, sw), (0, pw), (dh, dw),
                        m.groups)

    return row_op(rows, RowOp(kh, sh, ph, dh), run, pad_value=pad_value)


def norm_rows(norms, rows, train):
    """BatchNorm (:func:`rows_batch_norm`); a group or instance norm,
    whose statistics are each image's, has no row plan."""
    if isinstance(norms[0], basenetworks.BatchNorm):
        return rows_batch_norm(norms, rows, train)
    raise ValueError(f'spatial forward: no row plan for '
                     f'{type(norms[0]).__name__}')


def cna_rows(ms, rows, train):
    m = ms[0]
    x = norm_rows(_sub(ms, 'norm'), conv_rows(_sub(ms, 'conv'), rows), train)
    if not m.act:
        return x
    return x.map(lambda k, t: basenetworks.activation(t, m.non_linearity))


def seq_rows(seqs, rows, train):
    """Modules in sequence; ``seqs[k]`` the sequence of local shard k."""
    for ms in zip(*seqs):
        rows = module_rows(list(ms), rows, train)
    return rows


def _interleave(k, a, b):
    return basenetworks.channel_interleave2(a, b)


def irk_rows(ms, rows, train):
    """``InvertedResidualK``: the split, the branches and the interleave
    row-local, the branches' convs through the plan."""
    branch2 = [list(m.branch2) for m in ms]
    if ms[0].branch1 is None:
        x1 = rows.map(lambda k, t: t.chunk(2, dim=1)[0])
        x2 = rows.map(lambda k, t: t.chunk(2, dim=1)[1])
        return x1.map2(seq_rows(branch2, x2, train), _interleave)
    y1 = seq_rows([list(m.branch1) for m in ms], rows, train)
    return y1.map2(seq_rows(branch2, rows, train), _interleave)


def _residual(ms, rows, y, train):
    if ms[0].projection is None:
        residual = rows
    else:
        residual = cna_rows(_sub(ms, 'projection'), rows, train)
    return residual.map2(y, lambda k, a, b: F.relu(a + b))


def basic_block_rows(ms, rows, train):
    y = cna_rows(_sub(ms, 'conv2'),
                 cna_rows(_sub(ms, 'conv1'), rows, train), train)
    return _residual(ms, rows, y, train)


def bottleneck_rows(ms, rows, train):
    y = rows
    for name in ('conv1', 'conv2', 'conv3'):
        y = cna_rows(_sub(ms, name), y, train)
    return _residual(ms, rows, y, train)


def stem_rows(ms, rows, train):
    """ResNet's stem: the 7x7 conv, BatchNorm, ReLU and the 3x3 max pool,
    whose padding rows are -inf."""
    x = conv_rows(_sub(ms, 'conv'), rows)
    x = norm_rows(_sub(ms, 'norm'), x, train).map(lambda k, t: F.relu(t))
    stride = ms[0].pool0_stride
    if not stride:
        return x
    return row_op(x, RowOp(3, stride, 1),
                  lambda k, t: F.max_pool2d(t, 3, stride=stride,
                                            padding=(0, 1)),
                  pad_value=-math.inf)


def backbone_rows(ms, rows, train):
    """A backbone's stages in sequence (``Backbone._stages``)."""
    return seq_rows([list(m._stages()) for m in ms], rows, train)


def _handlers():
    # read when called: ``basenetworks`` imports this package
    b = basenetworks
    return ((b.ConvNormAct, cna_rows), (b.InvertedResidualK, irk_rows),
            (b.BasicBlock, basic_block_rows),
            (b.Bottleneck, bottleneck_rows), (b.ResnetStem, stem_rows),
            (b.ShuffleNetV2K, backbone_rows), (b.Resnet, backbone_rows))


def module_rows(ms, rows, train):
    for cls, handler in _handlers():
        if isinstance(ms[0], cls):
            return handler(ms, rows, train)
    raise ValueError(f'spatial forward: no row plan for '
                     f'{type(ms[0]).__name__}')


def _dropout_rows(rows, p, generator):
    """``heads.dropout`` with the draws of the whole tensor (one draw, as
    the unsharded head makes), each shard keeping its rows'."""
    first = rows.parts[0]
    shape = list(first.shape)
    shape[rows.dim] = rows.height
    keep = torch.rand(shape, generator=generator, device=first.device) \
        < 1.0 - p
    parts = []
    for (s, e), x in zip(rows.local_ranges, rows.parts):
        mask = keep.narrow(rows.dim, s, e - s).to(x.device)
        parts.append(torch.where(mask, x / (1.0 - p),
                                 torch.zeros((), dtype=x.dtype,
                                             device=x.device)))
    return rows.like(parts)


def _crop_rows(rows, low, high):
    """Keep global rows ``[low, height - high)`` (and as many columns off
    each side of W), renumbered from 0."""
    height = rows.height - low - high
    ranges = [(min(max(s - low, 0), height), min(max(e - low, 0), height))
              for s, e in rows.ranges]
    parts = []
    for (s, e), (ns, ne), x in zip(rows.local_ranges,
                                   [ranges[j] for j in rows.axis.local],
                                   rows.parts):
        start = ns + low - s
        parts.append(x.narrow(rows.dim, start, ne - ns)
                     [..., low:x.shape[-1] - high])
    return rows.like(parts, ranges, height)


def head_rows(hs, rows, train=False, generator=None):
    """``CompositeField4`` on NCHW feature rows; returns (B, F, C, h, w)
    field rows (split along dim 3)."""
    head = hs[0]
    meta = head.meta
    upsample = meta.upsample_stride
    if train and head.dropout_p > 0.0:
        rows = _dropout_rows(rows, head.dropout_p, generator)
    x = rows.map(lambda k, t: hs[k].conv(t))
    if upsample > 1:
        x = x.like([heads.pixel_shuffle(p, upsample) for p in x.parts],
                   [(upsample * s, upsample * e) for s, e in x.ranges],
                   upsample * x.height)
        x = _crop_rows(x, (upsample - 1) // 2,
                       math.ceil((upsample - 1) / 2.0))
    x = x.like([p.reshape(p.shape[0], meta.n_fields, meta.n_components,
                          p.shape[2], p.shape[3]) for p in x.parts], dim=3)
    if train:
        return x
    return x.like([heads.postprocess(p, meta, s) for (s, _), p in
                   zip(x.local_ranges, x.parts)])


def heads_rows(head_nets, features, *, train=False, head_mask=None,
               generator=None):
    """Each head on the feature rows (None where masked);
    ``head_nets[k]`` the heads of local shard k."""
    n = len(head_nets[0])
    if head_mask is None:
        head_mask = [True] * n
    return tuple(
        head_rows([hn[i] for hn in head_nets], features, train, generator)
        if m else None for i, m in enumerate(head_mask))


def shell_rows(shells, images, axis, *, train=False, head_mask=None,
               bn_train=None, generator=None):
    """``Shell.forward`` of NHWC ``images`` split over ``axis``, one shell
    per local shard: field rows per head."""
    features = backbone_rows([s.base_net for s in shells],
                             images_to_rows(images, axis),
                             train if bn_train is None else bn_train)
    return heads_rows([s.head_nets for s in shells], features, train=train,
                      head_mask=head_mask, generator=generator)


def gather_fields(fields, device, *, scale=1):
    """Each head's whole fields on ``device`` (None stays None)."""
    return tuple(None if f is None else gather(f, device, scale=scale)
                 for f in fields)
