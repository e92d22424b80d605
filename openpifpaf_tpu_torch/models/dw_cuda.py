"""Depthwise convolution: wrapper of the hand-written CUDA kernel
``csrc/depthwise.cu``.

Replaces the Pallas TPU kernel ``openpifpaf_tpu/models/dw_pallas.py::
_dw_kernel`` (driven by ``depthwise_conv``): a stride-1 'SAME' KxK
depthwise convolution with dilation, plus bias, plus an optional ReLU or
leaky ReLU, on the NHWC activation (a channels_last tensor). It sums in
float32 for float32 and bfloat16 storage alike (the TPU kernel sums in the
storage type). The same kernel has a VALID mode, the conv alone of an
input whose halo is data, which the Mosaic lab's ``dw_valid``
(:mod:`..lab.kernels`) launches through :func:`launch`.

On the H100 the function is bound by bytes (25 multiply-adds per element
at K=5). The kernel stages a CTA's haloed tile of one channel group in
shared memory with ``cp.async``, in vectors as wide as the pixel stride
allows, keeps each thread's taps in registers and slides a window of input
rows down a strip of 8 outputs, so that a staged value is loaded once per
thread and serves up to K outputs. :func:`plan` picks the vector width,
channel groups and tile per call so that the grid fills the card.

:func:`depthwise_conv` runs :func:`depthwise_conv_plain` for a tensor on
the CPU; for a CUDA tensor it launches the kernel or raises.
"""

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from .. import _nvcc
from .basenetworks import activation

#: kernel launches made by :func:`depthwise_conv` in this process
LAUNCHES = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
             + [ctypes.c_int] * 14 + [ctypes.c_void_p])

#: the kernel sizes the kernel is built for
KERNEL_SIZES = (3, 5, 7)
MAX_THREADS = 256
#: channel vectors per CTA at most
MAX_VECTORS = 32
#: strips (one thread's work) a launch should have at least: 16 warps per
#: SM of the H100, which the kernel needs to hide its loads' latency (at
#: k16's stages 3 and 4, 2-channel vectors ran faster than wider ones)
MIN_STRIPS = 132 * 16 * 32
#: the H100's SMs, and the shared memory a CTA may use
SMS = 132
SMEM_LIMIT = 227 * 1024
#: the VALID mode's plan: vectors of at most this many channels (wider
#: ones hold their taps in the storage type and need ~250 registers), and
#: this many vectors per CTA
VALID_MAX_VEC = 4
VALID_VECTORS = 4


@dataclasses.dataclass(frozen=True)
class Plan:
    """Launch plan of the depthwise kernel."""
    vec: int      # channels per vector load (1, 2, 4 or 8)
    nv: int       # channel vectors per CTA
    groups: int   # channel groups (grid y)
    tw: int       # tile columns
    strips: int   # strips of strip_rows(vec) rows per tile (= dilation)
    threads: int  # nv * tw * strips
    smem: int     # shared bytes of the haloed tile
    ctas: int


def strip_rows(vec):
    """Output rows per thread (``strip_rows`` in csrc/depthwise.cu)."""
    return 4 if vec == 8 else 8


@functools.lru_cache(maxsize=None)
def plan(n, h, w, c, *, k, dilation, dtype, align=16, valid=False) -> Plan:
    """The launch plan for an (n, h, w, c) output whose tensors are aligned
    to ``align`` bytes; ``valid`` plans the VALID mode, whose input is
    (n, h + 2 halo, w + 2 halo, c).

    'SAME': the widest vector (at most 16 bytes) that divides C and the
    alignment and still leaves :data:`MIN_STRIPS` threads' strips of work
    (the narrowest legal one where none does), one strip per dilation
    phase, and the fewest channel groups (at most :data:`MAX_VECTORS`
    vectors, at least 4 unless C is narrower). VALID: the widest legal
    vector of at most :data:`VALID_MAX_VEC` channels, two strips per
    dilation phase (16-row tiles, less halo per output) and channel groups
    of :data:`VALID_VECTORS` vectors: small CTAs, many per SM, which at the
    Mosaic lab's stages on the H100 beat the 'SAME' rule's plans in both
    types. Then, in both, the widest tile (16 columns first: the halo's
    share of the staged tile falls with the width) that gives two CTAs per
    SM; where none does, the plan with the most CTAs."""
    size = torch.finfo(dtype).bits // 8
    legal = [v for v in (8, 4, 2, 1) if v * size <= 16 and c % v == 0
             and align % (v * size) == 0]
    if valid:
        vec = next(v for v in legal if v <= VALID_MAX_VEC)
    else:
        vec = next((v for v in legal if n * -(-h // strip_rows(v)) * w
                    * (c // v) >= MIN_STRIPS), legal[-1])
    nvec = c // vec
    halo = (k - 1) // 2 * dilation
    strips = 2 * dilation if valid else dilation
    th = strips * strip_rows(vec)
    rows = -(-h // th)
    vectors = [min(nvec, VALID_VECTORS)] if valid else \
        range(min(nvec, MAX_VECTORS), min(nvec, 4) - 1, -1)
    best = None
    for tw in (16, 8, 4, 2, 1):
        for nv in vectors:
            groups = -(-nvec // nv)
            smem = (th + 2 * halo) * (tw + 2 * halo) * nv * vec * size
            if nv * tw * strips > MAX_THREADS or smem > SMEM_LIMIT:
                continue
            p = Plan(vec=vec, nv=nv, groups=groups, tw=tw, strips=strips,
                     threads=nv * tw * strips, smem=smem,
                     ctas=rows * -(-w // tw) * groups * n)
            if p.ctas >= 2 * SMS:
                return p
            if best is None or p.ctas > best.ctas:
                best = p
    if best is None:
        raise ValueError(f'depthwise kernel: no plan fits a CTA for '
                         f'(N, H, W, C) = {(n, h, w, c)}, k={k}, '
                         f'dilation={dilation}')
    return best


def alignment(*tensors):
    """The largest power of two, at most 16, dividing every data pointer."""
    align = 16
    for t in tensors:
        while t.data_ptr() % align:
            align //= 2
    return align


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
    if kernel.shape != (c, 1, k, k) or k not in KERNEL_SIZES:
        raise ValueError(f'kernel must be ({c}, 1, K, K) with K in '
                         f'{KERNEL_SIZES}, got {tuple(kernel.shape)}')
    if bias.shape != (c,):
        raise ValueError(f'bias must be ({c},), got {tuple(bias.shape)}')
    if x.numel() >= 2 ** 31:
        raise ValueError(f'depthwise kernel takes fewer than 2^31 elements, '
                         f'got {tuple(x.shape)}')
    for name, t in (('kernel', kernel), ('bias', bias)):
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f'{name} is {t.dtype} on {t.device}, x is '
                             f'{x.dtype} on {x.device}')


def launch(x, kernel, bias, *, dilation=1, act=0):
    """Launch the kernel on the checked channels_last CUDA tensor ``x``
    with contiguous ``kernel`` (C, 1, K, K) and return its (N, C, H, W)
    output: 'SAME' with ``bias`` (C,) and ``act`` (0 none, 1 ReLU, 2
    leaky), or VALID when ``bias`` is None (x is then (N, C, H + 2 halo,
    W + 2 halo), its halo data, and ``act`` 0). Counts nothing: the
    wrappers do."""
    valid = bias is None
    n, c, h, w = x.shape
    k = kernel.shape[-1]
    if valid:
        halo = (k - 1) // 2 * dilation
        h, w = h - 2 * halo, w - 2 * halo
    out = torch.empty((n, c, h, w), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    p = plan(n, h, w, c, k=k, dilation=dilation, dtype=x.dtype,
             align=alignment(x, out), valid=valid)
    _nvcc.launch(_nvcc.function('depthwise.cu', 'depthwise_conv', _ARGTYPES),
                 x.device, DTYPES[x.dtype], int(valid), x.data_ptr(),
                 kernel.data_ptr(), 0 if valid else bias.data_ptr(),
                 out.data_ptr(), n, h, w, c, k, dilation, act, p.vec, p.nv,
                 p.groups, p.tw, p.strips, p.threads, p.smem)
    return out


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
    out = launch(x, kernel.contiguous(), bias.contiguous(),
                 dilation=dilation, act=(2 if leaky else 1) if act else 0)
    LAUNCHES += 1
    return out
