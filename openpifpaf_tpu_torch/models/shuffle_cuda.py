"""Fused ShuffleNetV2K block: wrapper of the hand-written CUDA kernel
``csrc/shuffle_block.cu``.

Replaces the Pallas TPU kernel ``openpifpaf_tpu/models/shuffle_pallas.py::
_block_kernel`` (driven by ``fused_block``): one whole BN-folded non-first
``InvertedResidualK`` block in one launch, with y1 and z kept on chip, so
that the block reads its input once and writes its output once:

    x1, x2 = split(x)
    y1 = act(x2 . W1 + b1)          float32
    z = depthwise(y1) + bdw         rounded to the storage type
    out = interleave(x1, act(z . W3 + b3))

The TPU kernel pads each channel half to 128 lanes in a halo-framed,
flattened array and folds the interleave into one-hot scatter matmuls.
Here the activation stays a plain channels_last ``(N, 2Cb, H, W)`` tensor,
the split is a pointer offset of ``Cb``, and the interleave an output index
map. The same source computes branch2 alone (``interleave=False``), which
:mod:`.block_cuda` wraps.

:func:`fused_block` runs :func:`fused_block_plain` for a tensor on the
CPU; for a CUDA tensor it launches the kernel or raises.
"""

import ctypes
import dataclasses

import torch
import torch.nn.functional as F

from .. import _nvcc
from .basenetworks import activation, channel_interleave2
from .dw_cuda import DTYPES

#: kernel launches made by :func:`fused_block` in this process
LAUNCHES = 0

#: the kernel's largest halo, (k - 1) // 2 * dilation
MAX_HALO = 4
_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
             + [ctypes.c_int] * 7 + [ctypes.c_void_p])


@dataclasses.dataclass
class BlockWeights:
    """BN-folded weights of one non-first block, in the activation's type.
    The 1x1 matrices are ``[in, out]``; nothing is padded."""
    w1: torch.Tensor   # (Cb, Cb) first 1x1
    b1: torch.Tensor   # (Cb,)
    wdw: torch.Tensor  # (Cb, 1, K, K) depthwise
    bdw: torch.Tensor  # (Cb,)
    w3: torch.Tensor   # (Cb, Cb) second 1x1
    b3: torch.Tensor   # (Cb,)

    def tensors(self):
        return [getattr(self, f.name) for f in dataclasses.fields(self)]


def block_weights_from_folded(block) -> BlockWeights:
    """BlockWeights of a non-first ``fused_inference.FoldedBlock``, in its
    convs' type and on their device."""
    pw1, dw, pw3 = block.convs
    return BlockWeights(
        w1=pw1.weight[:, :, 0, 0].t().contiguous(), b1=pw1.bias.contiguous(),
        wdw=dw.weight.contiguous(), bdw=dw.bias.contiguous(),
        w3=pw3.weight[:, :, 0, 0].t().contiguous(), b3=pw3.bias.contiguous())


def branch2_plain(x, weights, *, k, dilation=1, leaky=False):
    """Branch2 of the block on ``x``'s second channel half, with the
    kernel's rounding points: y1 in float32, z rounded to ``x.dtype``, the
    output rounded once. Returns (N, Cb, H, W)."""
    non_linearity = 'leaky_relu' if leaky else 'relu'
    cb = x.shape[1] // 2
    w = weights
    y1 = activation(F.conv2d(x[:, cb:].float(),
                             w.w1.t().float()[:, :, None, None],
                             w.b1.float()), non_linearity)
    pad = (k - 1) // 2 * dilation
    z = F.conv2d(y1, w.wdw.float(), w.bdw.float(), padding=pad,
                 dilation=dilation, groups=cb)
    z = z.to(x.dtype).float()
    y3 = activation(F.conv2d(z, w.w3.t().float()[:, :, None, None],
                             w.b3.float()), non_linearity)
    return y3.to(x.dtype)


def fused_block_plain(x, weights, *, k, dilation=1, leaky=False):
    """The kernel's plain PyTorch version: the whole block, interleaved."""
    cb = x.shape[1] // 2
    return channel_interleave2(
        x[:, :cb], branch2_plain(x, weights, k=k, dilation=dilation,
                                 leaky=leaky))


def launch(x, weights, *, k, dilation, leaky, interleave):
    """Launch the kernel on the CUDA tensor ``x`` and return its output:
    the whole block's (N, 2Cb, H, W), or branch2's (N, Cb, H, W) when not
    ``interleave``. Counts nothing: the wrappers do."""
    if x.device.type != 'cuda':
        raise ValueError(f'block kernel needs a CUDA tensor, got {x.device}')
    if x.dim() != 4 or x.shape[1] % 2 or not x.is_contiguous(
            memory_format=torch.channels_last):
        raise ValueError('block kernel needs a 4-d channels_last tensor '
                         f'with an even channel count, got '
                         f'{tuple(x.shape)} with strides {x.stride()}')
    if x.dtype not in DTYPES:
        raise ValueError(f'block kernel takes {list(DTYPES)}, got {x.dtype}')
    n, c2, h, w = x.shape
    cb = c2 // 2
    want = [(cb, cb), (cb,), (cb, 1, k, k), (cb,), (cb, cb), (cb,)]
    for f, t, shape in zip(dataclasses.fields(weights), weights.tensors(),
                           want):
        if tuple(t.shape) != shape or t.dtype != x.dtype \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError(f'{f.name}: {tuple(t.shape)} {t.dtype} on '
                             f'{t.device}, wanted contiguous {shape} '
                             f'{x.dtype} on {x.device}')
    halo = (k - 1) // 2 * dilation
    if k % 2 == 0 or not 1 <= halo <= MAX_HALO:
        raise ValueError(f'block kernel takes odd k with (k - 1) // 2 * '
                         f'dilation in 1..{MAX_HALO}, got k={k}, '
                         f'dilation={dilation}')
    out = torch.empty((n, c2 if interleave else cb, h, w), dtype=x.dtype,
                      device=x.device, memory_format=torch.channels_last)
    _nvcc.launch(_nvcc.function('shuffle_block.cu', 'shuffle_block',
                                _ARGTYPES),
                 x.device, DTYPES[x.dtype], int(interleave), x.data_ptr(),
                 *[t.data_ptr() for t in weights.tensors()], out.data_ptr(),
                 n, h, w, cb, k, dilation, 2 if leaky else 1)
    return out


def fused_block(x, weights, *, k, dilation=1, leaky=False):
    """One non-first block on the channels_last (N, 2Cb, H, W) activation;
    returns the interleaved (N, 2Cb, H, W) output, channels_last."""
    global LAUNCHES
    if x.device.type == 'cpu':
        return fused_block_plain(x, weights, k=k, dilation=dilation,
                                 leaky=leaky)
    out = launch(x, weights, k=k, dilation=dilation, leaky=leaky,
                 interleave=True)
    LAUNCHES += 1
    return out
