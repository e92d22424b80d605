"""BN-folded inference engine for ShuffleNetV2K backbones (port of
``openpifpaf_tpu/models/fused_inference.py``).

With its running statistics frozen, ``BN(conv(x))`` is exactly
``conv'(x) + b`` with the scale folded into the convolution's weights.
:func:`fold_shufflenet` folds every ``ConvNormAct`` of a port
``ShuffleNetV2K`` once, in float64, and the serving forward runs the
backbone as convolutions with bias and activation, without the separate
BatchNorm launches of the module graph.

Engines over the fold:
- ``FoldedShuffleNetV2K`` in mode ``'conv'``: every conv on cuDNN
  (the Predictor's ``'folded'``; the TPU layout workarounds ``'halves'``
  and ``'stencil'`` are aliases of it);
- mode ``'dwpallas'``: every stride-1 depthwise conv through the CUDA
  kernel of :mod:`.dw_cuda` (byte-bound: shared-memory tiles in vectors
  as wide as the pixel stride allows, each thread a strip of outputs with
  its taps in registers);
- :func:`build_pallas_forward`: every non-first stride-1 block through the
  fused-block CUDA kernel of :mod:`.shuffle_cuda` (y1 and z on chip; a
  cluster of CTAs per tile splits the channels, tensor cores in bfloat16);
- ``block_cuda.build_mosaic_forward``: the same blocks through the branch2
  mode of that kernel, interleaved in PyTorch.
The stem, the strided first-in-stage blocks and conv5 stay on cuDNN in
every engine, as they stay on XLA convolutions in the JAX package.

:func:`folded_rows_forward` and :func:`block_rows_forward` run the same
engines on an image split along H over the spatial mesh's shards, the
kernels on haloed tiles (see the section below).
"""

import dataclasses
import functools
from typing import List, Union

import torch
from torch import nn
import torch.nn.functional as F

from . import dw_cuda, shuffle_cuda
from ..parallel import spatial
from .basenetworks import ShuffleNetV2K, activation, channel_interleave2

MODES = ('conv', 'dwpallas')


@dataclasses.dataclass
class FoldedConv:
    """One ConvNormAct with its BatchNorm folded into weight + bias."""
    weight: torch.Tensor  # (O, I / groups, K, K)
    bias: torch.Tensor    # (O,)
    stride: int = 1
    groups: int = 1
    dilation: int = 1
    act: bool = True
    non_linearity: str = 'relu'
    #: 'conv' (cuDNN) | 'dwpallas' (stride-1 depthwise convs through the
    #: CUDA kernel of :mod:`.dw_cuda`, every other conv on cuDNN)
    mode: str = 'conv'

    @property
    def padding(self):
        return (self.weight.shape[-1] - 1) // 2 * self.dilation

    def on_kernel(self):
        """Whether the call launches the depthwise kernel."""
        return self.mode == 'dwpallas' and self.weight.shape[1] == 1 \
            and self.groups == self.weight.shape[0] \
            and self.weight.shape[-1] > 1 and self.stride == 1

    def __call__(self, x, pad_rows=True):
        """The conv of ``x``; ``pad_rows=False`` pads along W only (a
        shard's tile, whose rows' padding is the row plan's)."""
        if self.on_kernel():
            return dw_cuda.depthwise_conv(
                x, self.weight, self.bias, dilation=self.dilation,
                act=self.act, leaky=self.non_linearity == 'leaky_relu')
        pad = self.padding
        y = F.conv2d(x, self.weight, self.bias, stride=self.stride,
                     padding=(pad if pad_rows else 0, pad),
                     dilation=self.dilation, groups=self.groups)
        return activation(y, self.non_linearity) if self.act else y


@dataclasses.dataclass
class FoldedBlock:
    """InvertedResidualK with all three (or five) convs BN-folded, in the
    order of the flax ``ConvNormAct_0..N``: branch1 then branch2."""
    first_in_stage: bool
    convs: List[FoldedConv]

    def __call__(self, x):
        if not self.first_in_stage:
            cna0, cna1, cna2 = self.convs
            x1, x2 = x.chunk(2, dim=1)
            return channel_interleave2(x1, cna2(cna1(cna0(x2))))
        dw1, pw1, pw2, dw2, pw3 = self.convs
        return channel_interleave2(pw1(dw1(x)), pw3(dw2(pw2(x))))


def _map_convs(op, fn):
    if isinstance(op, FoldedConv):
        return fn(op)
    return dataclasses.replace(op, convs=[fn(c) for c in op.convs])


@dataclasses.dataclass
class FoldedShuffleNetV2K:
    stem: List[FoldedConv]
    blocks: List[FoldedBlock]
    conv5: List[Union[FoldedConv, FoldedBlock]]

    def __call__(self, x):
        for op in self.stem + self.blocks + self.conv5:
            x = op(x)
        return x

    def _map(self, fn):
        return FoldedShuffleNetV2K(
            stem=[fn(c) for c in self.stem],
            blocks=[_map_convs(b, fn) for b in self.blocks],
            conv5=[_map_convs(op, fn) for op in self.conv5])

    def cast(self, dtype):
        """A copy with every weight and bias in ``dtype`` (once, at set-up,
        not per call)."""
        return self._map(lambda c: dataclasses.replace(
            c, weight=c.weight.to(dtype), bias=c.bias.to(dtype)))

    def with_mode(self, mode):
        """A copy with every conv's compute mode set (:data:`MODES`)."""
        if mode not in MODES:
            raise ValueError(f'unknown mode {mode!r}; one of {MODES}')
        return self._map(lambda c: dataclasses.replace(c, mode=mode))


def _fold_cna(cna):
    """Fold one ConvNormAct's BatchNorm (running statistics) into its conv,
    in float64, rounded to float32 once."""
    conv, norm = cna.conv, cna.norm
    if not isinstance(norm, nn.BatchNorm2d) or norm.running_var is None:
        raise ValueError(f'cannot fold {norm}: only BatchNorm with running '
                         'statistics folds')
    with torch.no_grad():
        s = norm.weight.double() / torch.sqrt(norm.running_var.double()
                                              + norm.eps)
        weight = (conv.weight.double() * s[:, None, None, None]).float()
        bias = (norm.bias.double() - norm.running_mean.double() * s).float()
    return FoldedConv(weight=weight, bias=bias, stride=conv.stride[0],
                      groups=conv.groups, dilation=conv.dilation[0],
                      act=cna.act, non_linearity=cna.non_linearity)


def _fold_block(block):
    cnas = list(block.branch1 or []) + list(block.branch2)
    return FoldedBlock(first_in_stage=block.first_in_stage,
                       convs=[_fold_cna(c) for c in cnas])


def fold_shufflenet(base_net) -> FoldedShuffleNetV2K:
    """Fold a port ``ShuffleNetV2K``'s BatchNorms, on its device; raises
    ``ValueError`` for a backbone that does not fold."""
    if not isinstance(base_net, ShuffleNetV2K):
        raise ValueError(f'cannot fold a {type(base_net).__name__}: only a '
                         'ShuffleNetV2K backbone folds')
    stem = [_fold_cna(base_net.input_block)]
    if base_net.input_conv2 is not None:
        stem.append(_fold_cna(base_net.input_conv2))
    blocks = [_fold_block(b) for b in base_net.blocks]
    if base_net.conv5_as_stage:
        conv5 = [_fold_block(b) for b in base_net.conv5]
    else:
        conv5 = [_fold_cna(base_net.conv5)]
    return FoldedShuffleNetV2K(stem=stem, blocks=blocks, conv5=conv5)


def _block_ops(folded, dtype, fused_op):
    folded = folded.cast(dtype)
    ops = []
    for op in folded.blocks + folded.conv5:
        if isinstance(op, FoldedBlock) and not op.first_in_stage \
                and all(c.stride == 1 for c in op.convs):
            dw = op.convs[1]
            ops.append(functools.partial(
                fused_op, weights=shuffle_cuda.block_weights_from_folded(op),
                k=dw.weight.shape[-1], dilation=dw.dilation,
                leaky=dw.non_linearity == 'leaky_relu'))
        else:
            ops.append(op)
    return folded.stem + ops


def block_forward(folded, dtype, fused_op):
    """Forward fn of ``folded`` in ``dtype`` with every non-first stride-1
    block replaced by ``fused_op(x, weights, k=, dilation=, leaky=)``.
    Takes and returns channels_last NCHW tensors."""
    ops = _block_ops(folded, dtype, fused_op)

    def forward(x):
        x = x.to(dtype)
        for op in ops:
            x = op(x)
        return x

    return forward


def build_pallas_forward(folded, *, dtype=torch.bfloat16, impl='pallas'):
    """Forward fn with the non-first blocks through the fused-block kernel
    (``impl='pallas'``), or the folded graph (``'halves'``, a TPU layout
    workaround that the card does not need)."""
    if impl == 'halves':
        folded = folded.cast(dtype)
        return lambda x: folded(x.to(dtype))
    if impl != 'pallas':
        raise ValueError(f'unknown impl {impl!r}')
    return block_forward(folded, dtype, shuffle_cuda.fused_block)


def build_fused_backbone(model, dtype=torch.bfloat16):
    """The folded ``model.base_net`` with its weights in ``dtype``; raises
    ``ValueError`` when it does not fold."""
    return fold_shufflenet(getattr(model, 'base_net', model)).cast(dtype)


# The engines on an activation split along H (the spatial mesh). Each
# function takes the op of every local shard (the folds of the
# replica on each shard's device) and a ``parallel.spatial.Rows``. Both
# kernels pad 'SAME': a call that launches one runs on the shard's tile
# extended by the kernel's halo from real neighbours only (clipped at the
# global edges) and its output's halo rows are cropped
# (``spatial.halo_op``), which is exact at the global edges too. Padding
# the block's input with zero rows instead would not be: its first 1x1
# turns a zero row into relu(b1) before the depthwise reads it. Every
# other conv runs through the row plan, conv by conv (``spatial.row_op``).


def _channels_last(x):
    return x.contiguous(memory_format=torch.channels_last)


def conv_rows(convs, rows):
    """A :class:`FoldedConv` on its shard."""
    c = convs[0]
    if c.on_kernel():
        return spatial.halo_op(rows, c.padding,
                               lambda k, x: convs[k](_channels_last(x)))
    k = c.weight.shape[-1]
    if k == 1 and c.stride == 1:
        return rows.map(lambda j, x: convs[j](x))
    return spatial.row_op(rows, spatial.RowOp(k, c.stride, c.padding,
                                              c.dilation),
                          lambda j, x: convs[j](_channels_last(x),
                                                pad_rows=False))


def block_rows(blocks, rows):
    """A :class:`FoldedBlock` on its shard, conv by conv."""
    convs = [b.convs for b in blocks]

    def chain(indices, x):
        for i in indices:
            x = conv_rows([c[i] for c in convs], x)
        return x

    interleave = (lambda k, a, b: channel_interleave2(a, b))
    if not blocks[0].first_in_stage:
        x1 = rows.map(lambda k, t: t.chunk(2, dim=1)[0])
        x2 = rows.map(lambda k, t: t.chunk(2, dim=1)[1])
        return x1.map2(chain((0, 1, 2), x2), interleave)
    return chain((0, 1), rows).map2(chain((2, 3, 4), rows), interleave)


def op_rows(ops, rows):
    """One op of an engine's list on its shard: a conv, a block, or a
    fused-block kernel call (``functools.partial`` of ``fused_op``)."""
    op = ops[0]
    if isinstance(op, FoldedConv):
        return conv_rows(ops, rows)
    if isinstance(op, FoldedBlock):
        return block_rows(ops, rows)
    halo = (op.keywords['k'] - 1) // 2 * op.keywords['dilation']
    return spatial.halo_op(rows, halo,
                           lambda k, x: ops[k](_channels_last(x)))


def _rows_forward(op_lists, dtype):
    def forward(rows):
        rows = rows.map(lambda k, x: x.to(dtype))
        for ops in zip(*op_lists):
            rows = op_rows(list(ops), rows)
        return rows

    return forward


def folded_rows_forward(folds, dtype):
    """The spatial forward of :class:`FoldedShuffleNetV2K` ``folds`` (one
    per local shard, in their mode: ``'conv'`` or ``'dwpallas'``) in
    ``dtype``: ``fn(rows) -> rows``."""
    folds = [f.cast(dtype) for f in folds]
    return _rows_forward([f.stem + f.blocks + f.conv5 for f in folds], dtype)


def block_rows_forward(folds, dtype, fused_op):
    """The spatial forward of :func:`block_forward`: every non-first
    stride-1 block through ``fused_op`` on its shard's haloed tile."""
    return _rows_forward([_block_ops(f, dtype, fused_op) for f in folds],
                         dtype)
