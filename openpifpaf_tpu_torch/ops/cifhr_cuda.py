"""CifHr accumulation: wrapper of the hand-written CUDA kernel.

Replaces the Pallas TPU kernel ``openpifpaf_tpu/ops/cifhr_pallas.py::
_kernel`` (driven by ``accumulate_pallas``). The kernel,
``csrc/cifhr.cu``, runs one CTA per (field, 32x32 tile); each CTA streams
its field's cells through shared memory, culls those whose bounding box
misses the tile and accumulates the survivors in ascending cell order.
What bounds it on the H100 is the visiting of cells that miss a tile, not
HBM traffic (the 22 MB map at 641px is written once): the per-tile cull
keeps each pixel's loop to the cells that can touch it. There is no per-tile
budget, so unlike the Pallas kernel it is exact for any K and never
raises a tile overflow.

The kernel is built at first use by :mod:`openpifpaf_tpu_torch._nvcc`.

:func:`accumulate` runs the plain PyTorch version
(:func:`.cifhr.accumulate_dense`) for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises.
"""

import ctypes

import torch

from .. import _nvcc
from .cifhr import accumulate_dense

#: kernel launches made by :func:`accumulate` in this process
LAUNCHES = 0

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def accumulate(x, y, sigma, w, *, hr_h, hr_w, neighbors=16, factor=1.0):
    """CifHr map (F, hr_h, hr_w) from (F, K) cells; the contract of
    :func:`.cifhr.accumulate_dense`."""
    global LAUNCHES
    if x.device.type == 'cpu':
        return accumulate_dense(x, y, sigma, w, hr_h=hr_h, hr_w=hr_w,
                                neighbors=neighbors, factor=factor)
    if x.device.type != 'cuda':
        raise ValueError(f'CifHr kernel needs a CUDA tensor, got {x.device}')
    if x.dim() != 2:
        raise ValueError(f'cells must be (F, K), got {tuple(x.shape)}')
    for name, t in (('y', y), ('sigma', sigma), ('w', w)):
        if t.shape != x.shape or t.device != x.device:
            raise ValueError(f'{name} {tuple(t.shape)} on {t.device} does '
                             f'not match x {tuple(x.shape)} on {x.device}')
    for name, t in (('x', x), ('y', y), ('sigma', sigma), ('w', w)):
        if t.dtype != torch.float32:
            raise ValueError(f'{name} must be float32, got {t.dtype}')
    n_fields, n_cells = x.shape
    if n_fields * hr_h * hr_w >= 2 ** 31 or n_cells >= 2 ** 31:
        raise ValueError('CifHr map too large for 32-bit sizes')

    x, y, sigma = x.contiguous(), y.contiguous(), sigma.contiguous()
    weight = (w / neighbors * factor).contiguous()
    out = torch.empty((n_fields, hr_h, hr_w), dtype=torch.float32,
                      device=x.device)
    _nvcc.launch(_nvcc.function('cifhr.cu', 'cifhr_accumulate', _ARGTYPES),
                 x.device, x.data_ptr(), y.data_ptr(), sigma.data_ptr(),
                 weight.data_ptr(), out.data_ptr(), n_fields, n_cells, hr_h,
                 hr_w)
    LAUNCHES += 1
    return out
