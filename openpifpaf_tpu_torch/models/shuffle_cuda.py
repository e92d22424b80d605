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
Here the activation stays a plain channels_last ``(N, 2Cb, H, W)`` tensor
(padded to a multiple of 16 channels in shared memory only), the split is
a pointer offset of ``Cb``, and the interleave an output index map. The
same source computes branch2 alone (mode :data:`BRANCH2`), which
:mod:`.block_cuda` wraps, and the Mosaic lab's branch2 on an input whose
halo is data (mode :data:`LAB`), which ``lab.kernels.branch2`` launches
through :func:`call`.

On the H100 the block is bound by bytes in bfloat16 and by the two 1x1
products in float32. A thread-block cluster of CTAs shares one output
tile, each CTA a slice of the channels: the first 1x1's accumulators stay
in registers while x2's haloed tile and W1 stream through shared memory
with ``cp.async`` (x2 read once per CTA), the depthwise taps run on y1 in
shared memory, each CTA writes its slice of z into every CTA of the
cluster, and after a cluster barrier each computes its slice of the second
1x1. In bfloat16 both products run on tensor cores (``mma.sync``), in
float32 on CUDA cores as register-tiled outer products. :func:`plan`
picks the tile and the cluster per call so that the grid fills the card;
the kernel refuses a plan that does not fit.

:func:`fused_block` runs :func:`fused_block_plain` for a tensor on the
CPU; for a CUDA tensor it launches the kernel or raises.
"""

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from .. import _nvcc
from .basenetworks import activation, channel_interleave2
from .dw_cuda import DTYPES, alignment

#: kernel launches made by :func:`fused_block` in this process
LAUNCHES = 0

#: the kernel's largest halo, (k - 1) // 2 * dilation
MAX_HALO = 4
#: the kernel sizes the kernel is built for
KERNEL_SIZES = (3, 5, 7)
_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
             + [ctypes.c_int] * 13 + [ctypes.c_void_p])
#: the kernel's modes: branch2 of x's second channel half, the whole block,
#: the lab's branch2 of a pre-haloed x2
BRANCH2, BLOCK, LAB = 0, 1, 2

# the kernel's constants (csrc/shuffle_block.cu)
WARPS = 8
KS = 32          # input channels per staged K-slice
MT1 = 9          # 16-pixel m-tiles of the haloed tile, at most
MT2 = 4          # 16-pixel m-tiles of the output tile, at most
NT = 3           # 8-channel n-tiles per warp, at most
STRIP_ROWS = 8   # output rows per depthwise strip, at most
MAX_SLICE = WARPS * NT * 8
MAX_CLUSTER = 8
#: clusters the H100 runs at once, by cluster size, at one CTA per SM (the
#: kernel's registers allow no more): cudaOccupancyMaxActiveClusters on an
#: NVIDIA H100 80GB HBM3 (shuffle_cuda.resident_clusters). The SMs of a
#: cluster share a GPC, so 4 and 8 leave SMs idle.
RESIDENT_CLUSTERS = {1: 132, 2: 66, 4: 30, 8: 15}
#: the H100's SMs and the shared memory a CTA (and an SM) may use
SMS = 132
SMEM_LIMIT = 227 * 1024
#: a CTA's fixed cost (staging latency, barriers) in the plan's units of
#: work (multiply-adds on CUDA cores)
CTA_OVERHEAD = 50000


@dataclasses.dataclass(frozen=True)
class Plan:
    """Launch plan of the block kernel."""
    th: int       # output tile rows
    tw: int       # output tile columns
    cluster: int  # CTAs per tile, each owning `slice` channels
    slice: int
    vb: int       # bytes per staged vector
    smem: int     # shared bytes per CTA
    ctas: int

    @property
    def cb_pad(self):
        return self.cluster * self.slice


def shared_bytes(th, tw, cluster, slice_, *, k, halo, size):
    """Shared bytes of one CTA (``Layout`` in csrc/shuffle_block.cu)."""
    pin = (th + 2 * halo) * (tw + 2 * halo)
    m_pad = -(-pin // 16) * 16
    tp_pad = -(-(th * tw) // 16) * 16
    pe = 16 // size
    ws = slice_ + pe
    ring1 = 2 * (m_pad * (KS + pe) + KS * ws) * size
    taps = (pin * (slice_ + 4) + (k * k + 1) * slice_) * 4
    ring2 = (2 * KS + tp_pad) * ws * size  # W3's buffers, the tile's x1
    a_bytes = -(-max(ring1, taps, ring2) // 16) * 16
    z_bytes = -(-(tp_pad * (cluster * slice_ + pe) * size) // 16) * 16
    return a_bytes + z_bytes + (m_pad + tp_pad) * 8


@functools.lru_cache(maxsize=None)
def plan(n, h, w, cb, *, k, dilation, dtype, align=16, th=None) -> Plan:
    """The launch plan for the block on an (n, h, w, 2 cb) activation whose
    tensors are aligned to ``align`` bytes (in the lab mode, for the
    (n, h, w, cb) output of a pre-haloed x2, whose pixel stride cb gives
    the same copies); ``th`` fixes the tile rows, else the plan picks them.

    The channels are split over the smallest cluster of 1, 2, 4 or 8 CTAs
    that gives each CTA at most :data:`MAX_SLICE` channels (``slice``, a
    multiple of 16), so that the first 1x1's accumulators fit the
    registers; the output tile keeps the haloed tile within :data:`MT1`
    m-tiles and the output within :data:`MT2`. Of the plans that fit 227 KB, those with a CTA for each
    SM come first; among them the least estimated time: one CTA's work
    (the two 1x1s over the haloed and the output tile, both at 1/16 the
    cost on tensor cores in bfloat16, the taps, the bytes it stages, a
    fixed :data:`CTA_OVERHEAD`) times the waves of clusters
    (:data:`RESIDENT_CLUSTERS` run at once)."""
    size = torch.finfo(dtype).bits // 8
    halo = (k - 1) // 2 * dilation
    vb = next(v for v in (16, 8, 4, 2) if v >= size and (cb * size) % v == 0
              and align % v == 0)
    mma = 16 if dtype == torch.bfloat16 else 1
    best, best_key = None, None
    # the smallest cluster whose slice fits: a larger one only stages x2
    # again in more CTAs and sends z to more of them
    for cluster in sorted(RESIDENT_CLUSTERS):
        slice_ = -(-(-(-cb // cluster)) // 16) * 16
        if slice_ <= MAX_SLICE and cluster * slice_ - slice_ < cb:
            break
    else:
        raise ValueError(f'block kernel: Cb={cb} does not split over '
                         f'{MAX_CLUSTER} CTAs of {MAX_SLICE} channels')
    cb_pad = cluster * slice_
    rows = range(1, STRIP_ROWS * dilation + 1)
    asked = '' if th is None else f', {th} tile rows'
    if th is not None:
        rows = [th] if th in rows else []
    for th in rows:
        for tw in range(1, 65):
            pin = (th + 2 * halo) * (tw + 2 * halo)
            if -(-pin // 16) > MT1 or -(-(th * tw) // 16) > MT2:
                continue
            smem = shared_bytes(th, tw, cluster, slice_, k=k, halo=halo,
                                size=size)
            if smem > SMEM_LIMIT:
                continue
            ctas = -(-h // th) * -(-w // tw) * n * cluster
            m_pad = -(-pin // 16) * 16
            tp_pad = -(-(th * tw) // 16) * 16
            work = (slice_ * (m_pad + tp_pad) * cb_pad / mma
                    + th * tw * slice_ * k * k
                    + (m_pad * cb_pad + 2 * cb_pad * slice_) * size / 4
                    + CTA_OVERHEAD)
            waves = -(-ctas // (cluster * RESIDENT_CLUSTERS[cluster]))
            key = (ctas < SMS, waves * work)
            if best_key is None or key < best_key:
                best_key = key
                best = Plan(th=th, tw=tw, cluster=cluster, slice=slice_,
                            vb=vb, smem=smem, ctas=ctas)
    if best is None:
        raise ValueError(f'block kernel: no plan fits a CTA for Cb={cb}, '
                         f'k={k}, dilation={dilation}, {dtype}{asked} (at '
                         f'most {STRIP_ROWS * dilation} tile rows, {MT1} '
                         f'haloed and {MT2} output m-tiles, {SMEM_LIMIT} '
                         f'shared bytes)')
    return best


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
    if k not in KERNEL_SIZES or not 1 <= halo <= MAX_HALO:
        raise ValueError(f'block kernel takes k in {KERNEL_SIZES} with '
                         f'(k - 1) // 2 * dilation in 1..{MAX_HALO}, got '
                         f'k={k}, dilation={dilation}')
    out = torch.empty((n, c2 if interleave else cb, h, w), dtype=x.dtype,
                      device=x.device, memory_format=torch.channels_last)
    p = plan(n, h, w, cb, k=k, dilation=dilation, dtype=x.dtype,
             align=alignment(x, weights.w1, weights.w3))
    call(BLOCK if interleave else BRANCH2, x, weights, out, k=k,
         dilation=dilation, act=2 if leaky else 1, p=p)
    return out


def call(mode, x, weights, out, *, k, dilation, act, p):
    """The kernel's C entry in ``mode`` on checked CUDA tensors: input
    ``x``, ``weights`` (:class:`BlockWeights`, or the lab's float32-biased
    ones), ``out`` (N, C, H, W) whose H and W are the output's, plan
    ``p``."""
    n, _, h, w = out.shape
    _nvcc.launch(_nvcc.function('shuffle_block.cu', 'shuffle_block',
                                _ARGTYPES),
                 x.device, DTYPES[x.dtype], mode, x.data_ptr(),
                 *[t.data_ptr() for t in weights.tensors()], out.data_ptr(),
                 n, h, w, weights.w1.shape[0], k, dilation, act, p.th, p.tw,
                 p.cluster, p.slice, p.vb, p.smem)


def resident_clusters(p, *, dtype, device):
    """How many clusters of plan ``p`` (at k=5) the card at ``device`` runs
    at once, from ``cudaOccupancyMaxActiveClusters``: the CTAs of a wave."""
    n = ctypes.c_int(0)
    fn = _nvcc.function('shuffle_block.cu', 'shuffle_block_clusters',
                        [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)])
    with torch.cuda.device(device):
        err = fn(DTYPES[dtype], 5, p.cluster, p.smem, ctypes.byref(n))
    if err:
        raise RuntimeError(f'cudaOccupancyMaxActiveClusters: CUDA error {err}')
    return n.value


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
