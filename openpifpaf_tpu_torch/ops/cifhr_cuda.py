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

The kernel is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface at first use, keyed on the source's hash, and
loaded with ``ctypes``.

:func:`accumulate` runs the plain PyTorch version
(:func:`.cifhr.accumulate_dense`) for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises.
"""

import ctypes
import hashlib
import os
import subprocess
import threading

import torch

from .cifhr import accumulate_dense

#: kernel launches made by :func:`accumulate` in this process
LAUNCHES = 0

SOURCE = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                      'csrc', 'cifhr.cu')
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                         '_build')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC')

_LIB = None
_LIB_LOCK = threading.Lock()


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError('nvcc not found: set CUDA_HOME to the CUDA '
                           'toolkit to build the CifHr kernel')
    return os.path.join(CUDA_HOME, 'bin', 'nvcc')


def build():
    """Compile ``csrc/cifhr.cu`` unless a library for this exact source and
    these flags exists. Returns the library path."""
    with open(SOURCE, 'rb') as f:
        digest = hashlib.sha256(f.read() + ' '.join(NVCC_FLAGS).encode())
    lib_path = os.path.join(BUILD_DIR, f'libcifhr_{digest.hexdigest()[:16]}.so')
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{lib_path}.{os.getpid()}.tmp'
    cmd = [_nvcc(), *NVCC_FLAGS, '-o', tmp, SOURCE]
    done = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if done.returncode != 0:
        raise RuntimeError(f'nvcc failed ({done.returncode}):\n'
                           f'{done.stdout}{done.stderr}')
    os.replace(tmp, lib_path)
    return lib_path


def _library():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            fn = lib.cifhr_accumulate
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _LIB = lib
    return _LIB


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
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.cifhr_accumulate(
            x.data_ptr(), y.data_ptr(), sigma.data_ptr(), weight.data_ptr(),
            out.data_ptr(), n_fields, n_cells, hr_h, hr_w, stream)
    if err != 0:
        raise RuntimeError(f'CifHr kernel launch failed: CUDA error {err}')
    LAUNCHES += 1
    return out
