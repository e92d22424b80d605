"""Depthwise convolution: wrapper of the hand-written CUDA kernel
``csrc/depthwise.cu``.

Replaces the Pallas TPU kernel ``openpifpaf_tpu/models/dw_pallas.py::
_dw_kernel`` (driven by ``depthwise_conv``): a stride-1 'SAME' KxK
depthwise convolution with dilation, plus bias, plus an optional ReLU or
leaky ReLU. The kernel runs one thread per output element of the NHWC
activation (a channels_last tensor), channels fastest, with bounds checks
for the zero padding and the batch in the grid; it sums in float32 for
float32 and bfloat16 storage alike (the TPU kernel sums in the storage
type).

:func:`depthwise_conv` runs :func:`depthwise_conv_plain` for a tensor on
the CPU; for a CUDA tensor it launches the kernel or raises.
"""

import ctypes

import torch
import torch.nn.functional as F

from .. import _nvcc
from .basenetworks import activation

#: kernel launches made by :func:`depthwise_conv` in this process
LAUNCHES = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_void_p])


def depthwise_conv_plain(x, kernel, bias, *, dilation=1, act=True,
                         leaky=False):
    """The kernel's plain PyTorch version: float32 arithmetic on the
    storage type's values, rounded once to ``x.dtype``.

    x: (N, C, H, W); kernel: (C, 1, K, K); bias: (C,).
    """
    k = kernel.shape[-1]
    y = F.conv2d(x.float(), kernel.float(), bias.float(),
                 padding=(k - 1) // 2 * dilation, dilation=dilation,
                 groups=x.shape[1])
    if act:
        y = activation(y, 'leaky_relu' if leaky else 'relu')
    return y.to(x.dtype)


def _check(x, kernel, bias):
    if x.dim() != 4 or not x.is_contiguous(
            memory_format=torch.channels_last):
        raise ValueError('depthwise kernel needs a 4-d channels_last '
                         f'tensor, got {tuple(x.shape)} with strides '
                         f'{x.stride()}')
    if x.dtype not in DTYPES:
        raise ValueError(f'depthwise kernel takes {list(DTYPES)}, got '
                         f'{x.dtype}')
    c = x.shape[1]
    k = kernel.shape[-1]
    if kernel.shape != (c, 1, k, k) or k % 2 == 0:
        raise ValueError(f'kernel must be ({c}, 1, K, K) with K odd, got '
                         f'{tuple(kernel.shape)}')
    if bias.shape != (c,):
        raise ValueError(f'bias must be ({c},), got {tuple(bias.shape)}')
    if x.numel() >= 2 ** 31:
        raise ValueError(f'depthwise kernel takes fewer than 2^31 elements, '
                         f'got {tuple(x.shape)}')
    for name, t in (('kernel', kernel), ('bias', bias)):
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f'{name} is {t.dtype} on {t.device}, x is '
                             f'{x.dtype} on {x.device}')


def depthwise_conv(x, kernel, bias, *, dilation=1, act=True, leaky=False):
    """Stride-1 'SAME' depthwise conv + bias + optional activation.

    x: (N, C, H, W) channels_last, float32 or bfloat16; kernel:
    (C, 1, K, K) and bias (C,) in x's type. Returns (N, C, H, W)
    channels_last.
    """
    global LAUNCHES
    if x.device.type == 'cpu':
        return depthwise_conv_plain(x, kernel, bias, dilation=dilation,
                                    act=act, leaky=leaky)
    if x.device.type != 'cuda':
        raise ValueError(f'depthwise kernel needs a CUDA tensor, got '
                         f'{x.device}')
    _check(x, kernel, bias)
    kernel = kernel.contiguous()
    bias = bias.contiguous()
    out = torch.empty_like(x, memory_format=torch.channels_last)
    n, c, h, w = x.shape
    _nvcc.launch(_nvcc.function('depthwise.cu', 'depthwise_conv', _ARGTYPES),
                 x.device, DTYPES[x.dtype], x.data_ptr(), kernel.data_ptr(),
                 bias.data_ptr(), out.data_ptr(), n, h, w, c,
                 kernel.shape[-1], dilation, (2 if leaky else 1) if act else 0)
    LAUNCHES += 1
    return out
