"""The lab's kernels: wrappers of hand-written CUDA kernels.

Replace the Pallas TPU kernels of ``tools/mosaic_lab.py``:

- :func:`lane_interleave` (``interleave_kernel``): ``out[..., 2i] =
  a[..., i]``, ``out[..., 2i + 1] = b[..., i]``; ``csrc/mosaic_lab.cu``;
- :func:`dw_valid` (``dw_kernel``): VALID KxK depthwise conv of a
  pre-haloed input, no bias, no activation, summed in float32 and rounded
  once (the TPU kernel sums in the storage type); the VALID mode of the
  backbone's depthwise kernel, ``csrc/depthwise.cu``
  (:func:`..models.dw_cuda.launch`, planned by ``dw_cuda.plan``);
- :func:`branch2` (``branch2_kernel``): ``relu(z . W3 + b3)`` with ``z =
  dw(relu(x2 . W1 + b1)) + bd`` on an input whose halo is real data; y1
  and z are rounded to the storage type, as in the TPU kernel; the lab
  mode of the fused-block kernel, ``csrc/shuffle_block.cu``
  (:func:`..models.shuffle_cuda.call`, planned by ``shuffle_cuda.plan``).

Activations are channels_last ``(N, C, H, W)`` tensors (the lab's HWC
arrays with N = 1); 1x1 matrices are ``[in, out]``, depthwise weights
``(C, 1, K, K)``. :func:`from_lab_arrays` turns the lab's numpy arrays into
these tensors. Each wrapper runs its plain PyTorch version for a tensor on
the CPU, launches its kernel for a CUDA tensor (counting the launch in
``LAUNCHES``) and raises for any other device.
"""

import ctypes
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .. import _nvcc
from ..models import dw_cuda, shuffle_cuda
from ..models.dw_cuda import DTYPES, alignment

#: kernel launches made by each wrapper in this process (the backbone
#: wrappers' counters do not move)
LAUNCHES = {'lab_interleave': 0, 'lab_dw_valid': 0, 'lab_branch2': 0}
_INTERLEAVE_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                        + [ctypes.c_int] * 2 + [ctypes.c_void_p])

#: lab array name -> its layout; the names of ``tools/mosaic_lab.py``
LAB_LAYOUTS = {'a': 'hwc', 'b': 'hwc', 'x': 'hwc', 'x2': 'hwc',
               'wt': 'kkc', 'wd': 'kkc', 'w1': 'matrix', 'w3': 'matrix',
               'b1': 'vector', 'bd': 'vector', 'b3': 'vector'}
#: arrays the lab keeps in float32 whatever the storage type
LAB_FLOAT32 = ('b1', 'wd', 'bd', 'b3')


@dataclasses.dataclass
class Branch2Weights:
    """Weights of the lab's branch2: the 1x1 matrices ``[in, out]`` in the
    activation's type, the biases and depthwise weights in float32."""
    w1: torch.Tensor  # (C, C)
    b1: torch.Tensor  # (C,)
    wd: torch.Tensor  # (C, 1, K, K)
    bd: torch.Tensor  # (C,)
    w3: torch.Tensor  # (C, C)
    b3: torch.Tensor  # (C,)

    def tensors(self):
        return [getattr(self, f.name) for f in dataclasses.fields(self)]


def from_lab_arrays(dtype, device='cpu', **arrays):
    """The port's tensors of the lab's numpy arrays, by their lab names:
    HWC activations (``a``, ``b``, ``x``, ``x2``) become channels_last
    (1, C, H, W), (K, K, C) depthwise weights (``wt``, ``wd``) become
    (C, 1, K, K), ``[in, out]`` matrices and vectors stay as they are.
    Each goes to ``dtype``, except the lab's float32 arrays (``b1``,
    ``wd``, ``bd``, ``b3``). Returns a dict by name."""
    out = {}
    for name, a in arrays.items():
        layout = LAB_LAYOUTS[name]
        t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
        if layout == 'hwc':
            t = t.permute(2, 0, 1)[None].contiguous(
                memory_format=torch.channels_last)
        elif layout == 'kkc':
            t = t.permute(2, 0, 1)[:, None].contiguous()
        target = torch.float32 if name in LAB_FLOAT32 else dtype
        out[name] = t.to(device, target)
    return out


def branch2_plan(n, h, w, c, *, k=5, dtype, align=16, r_tile=None):
    """The launch plan of :func:`branch2` for an (n, h, w, c) output: the
    fused-block kernel's (``shuffle_cuda.plan``), with ``r_tile`` tile rows
    or the plan's choice; raises ValueError where none fits a CTA."""
    return shuffle_cuda.plan(n, h, w, c, k=k, dilation=1, dtype=dtype,
                             align=align, th=r_tile)


# ---------------------------------------------------------------- plain

def lane_interleave_plain(a, b):
    """(N, C, H, W) a, b -> (N, 2C, H, W), channels_last: one
    ``torch.stack`` on the NHWC views."""
    n, c, h, w = a.shape
    out = torch.stack([a.permute(0, 2, 3, 1), b.permute(0, 2, 3, 1)], -1)
    return out.reshape(n, h, w, 2 * c).permute(0, 3, 1, 2)


def dw_valid_plain(x, weight):
    """VALID depthwise conv in float32 on the storage values, rounded once
    to ``x.dtype``. x: (N, C, H + K - 1, W + K - 1); weight: (C, 1, K, K).
    Returns (N, C, H, W) channels_last."""
    y = F.conv2d(x.float(), weight.float(), groups=x.shape[1])
    return y.to(x.dtype).contiguous(memory_format=torch.channels_last)


def branch2_plain(x2, weights):
    """The lab's branch2 as three convolutions with the kernel's rounding
    points: y1 and z rounded to ``x2.dtype``, the output once.
    x2: (N, C, H + 2h, W + 2h). Returns (N, C, H, W) channels_last."""
    w = weights
    dtype = x2.dtype
    y1 = F.relu(F.conv2d(x2.float(), w.w1.t().float()[:, :, None, None],
                         w.b1.float()))
    y1 = y1.to(dtype).float()
    z = F.conv2d(y1, w.wd.float(), w.bd.float(), groups=x2.shape[1])
    z = z.to(dtype).float()
    y3 = F.relu(F.conv2d(z, w.w3.t().float()[:, :, None, None],
                         w.b3.float()))
    return y3.to(dtype).contiguous(memory_format=torch.channels_last)


# ------------------------------------------------------------- wrappers

def _check_activation(what, x):
    if x.dim() != 4 or not x.is_contiguous(
            memory_format=torch.channels_last):
        raise ValueError(f'{what} needs a 4-d channels_last tensor, got '
                         f'{tuple(x.shape)} with strides {x.stride()}')
    if x.dtype not in DTYPES:
        raise ValueError(f'{what} takes {list(DTYPES)}, got {x.dtype}')


def _check_tensor(what, name, t, shape, dtype, device,
                  memory_format=torch.contiguous_format):
    if tuple(t.shape) != shape or t.dtype != dtype or t.device != device \
            or not t.is_contiguous(memory_format=memory_format):
        raise ValueError(f'{what}: {name} is {tuple(t.shape)} {t.dtype} on '
                         f'{t.device}, wanted {memory_format} {shape} '
                         f'{dtype} on {device}')


def _route(what, x):
    """True for a CUDA tensor (launch), False for a CPU one (plain);
    raises for any other device."""
    if x.device.type == 'cpu':
        return False
    if x.device.type != 'cuda':
        raise ValueError(f'{what} needs a CPU or CUDA tensor, got '
                         f'{x.device}')
    return True


def lane_interleave(a, b):
    """(N, C, H, W) channels_last a and b, float32 or bfloat16 ->
    (N, 2C, H, W) channels_last with channel 2i from a and 2i + 1 from b."""
    if not _route('lane_interleave', a):
        return lane_interleave_plain(a, b)
    _check_activation('lane_interleave', a)
    _check_tensor('lane_interleave', 'b', b, tuple(a.shape), a.dtype,
                  a.device, torch.channels_last)
    n, c, h, w = a.shape
    if n * h * w * c >= 2 ** 31:
        raise ValueError(f'lane_interleave takes fewer than 2^31 elements, '
                         f'got {tuple(a.shape)}')
    out = torch.empty((n, 2 * c, h, w), dtype=a.dtype, device=a.device,
                      memory_format=torch.channels_last)
    _nvcc.launch(_nvcc.function('mosaic_lab.cu', 'lab_interleave',
                                _INTERLEAVE_ARGTYPES),
                 a.device, DTYPES[a.dtype], a.data_ptr(), b.data_ptr(),
                 out.data_ptr(), n * h * w, c)
    LAUNCHES['lab_interleave'] += 1
    return out


def dw_valid(x, weight):
    """VALID depthwise conv. x: (N, C, H + K - 1, W + K - 1) channels_last,
    float32 or bfloat16; weight: (C, 1, K, K) in x's type. Returns
    (N, C, H, W) channels_last."""
    if not _route('dw_valid', x):
        return dw_valid_plain(x, weight)
    _check_activation('dw_valid', x)
    n, c, hin, win = x.shape
    k = weight.shape[-1]
    _check_tensor('dw_valid', 'weight', weight, (c, 1, k, k), x.dtype,
                  x.device)
    if k not in dw_cuda.KERNEL_SIZES:
        raise ValueError(f'dw_valid takes K in {dw_cuda.KERNEL_SIZES}, got '
                         f'{k}')
    if hin < k or win < k:
        raise ValueError(f'dw_valid: input {hin}x{win} smaller than K={k}')
    if x.numel() >= 2 ** 31:
        raise ValueError(f'dw_valid takes fewer than 2^31 elements, got '
                         f'{tuple(x.shape)}')
    out = dw_cuda.launch(x, weight, None)
    LAUNCHES['lab_dw_valid'] += 1
    return out


def branch2(x2, weights, *, r_tile=None):
    """The lab's branch2 on x2: (N, C, H + 2h, W + 2h) channels_last,
    float32 or bfloat16, its halo real data; ``weights`` a
    :class:`Branch2Weights` with K 3, 5 or 7. ``r_tile`` is the kernel's
    tile rows (None: the plan's choice; see :func:`branch2_plan`), unused
    by the plain version. Returns (N, C, H, W) channels_last."""
    if not _route('branch2', x2):
        return branch2_plain(x2, weights)
    _check_activation('branch2', x2)
    n, c, hin, win = x2.shape
    k = weights.wd.shape[-1]
    halo = k // 2
    want = {'w1': ((c, c), x2.dtype), 'b1': ((c,), torch.float32),
            'wd': ((c, 1, k, k), torch.float32), 'bd': ((c,), torch.float32),
            'w3': ((c, c), x2.dtype), 'b3': ((c,), torch.float32)}
    for name, (shape, dtype) in want.items():
        _check_tensor('branch2', name, getattr(weights, name), shape, dtype,
                      x2.device)
    if k not in shuffle_cuda.KERNEL_SIZES or hin <= 2 * halo \
            or win <= 2 * halo:
        raise ValueError(f'branch2: K in {shuffle_cuda.KERNEL_SIZES} and an '
                         f'input larger than its halo, got K={k} and '
                         f'{hin}x{win}')
    h, w = hin - 2 * halo, win - 2 * halo
    p = branch2_plan(n, h, w, c, k=k, dtype=x2.dtype,
                     align=alignment(x2, weights.w1, weights.w3),
                     r_tile=r_tile)
    out = torch.empty((n, c, h, w), dtype=x2.dtype, device=x2.device,
                      memory_format=torch.channels_last)
    shuffle_cuda.call(shuffle_cuda.LAB, x2, weights, out, k=k, dilation=1,
                      act=1, p=p)
    LAUNCHES['lab_branch2'] += 1
    return out
