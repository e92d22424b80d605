"""ctypes wrapper around the native IO library (port of
``openpifpaf_tpu/io/native.py``; source ``csrc/pifpaf_io.cpp``, a copy of
the JAX package's).

Builds the shared library on first use with ``g++`` and the JAX package's
flags (``openpifpaf_tpu/csrc/Makefile``) into the port's build directory
(``--xla-compilation-cache``, :mod:`..compile_cache`), keyed on the
source's bytes and the flags, and exposes batched JPEG decode + long-edge
resize + pad + ImageNet normalization with a native thread pool: the
host-side input pipeline of serving. Where the library cannot be built
(no ``g++``, no ``jpeglib.h``), :func:`native_available` is False and the
``Predictor`` takes the PIL path, as in JAX; no device op is involved
either way.
"""

import ctypes
import logging
import os

import numpy as np

from .. import _nvcc

LOG = logging.getLogger(__name__)

SOURCE = os.path.join(_nvcc.CSRC, 'pifpaf_io.cpp')
CXX = 'g++'
#: ``CXXFLAGS`` of the JAX package's Makefile, plus ``-shared``
CXXFLAGS = ('-O3', '-march=native', '-fPIC', '-std=c++17', '-Wall',
            '-shared')
LDLIBS = ('-ljpeg', '-lpthread')

_lib = None
_build_attempted = False


def build():
    """Compile ``csrc/pifpaf_io.cpp`` into the build directory unless a
    library for these bytes and flags is there; returns its path. Raises
    ``RuntimeError`` (with the compiler's output) or ``OSError`` (no
    compiler) where it cannot."""
    return _nvcc.cached_build(SOURCE, lambda: CXX, CXXFLAGS, LDLIBS)


def _load_library():
    global _lib, _build_attempted
    if _lib is not None:
        return _lib
    if _build_attempted:
        return None
    _build_attempted = True
    try:
        lib = ctypes.CDLL(build())
    except (RuntimeError, OSError) as e:
        LOG.warning('could not build or load the native io library: %s', e)
        return None

    lib.pifpaf_load_batch.restype = ctypes.c_int
    lib.pifpaf_load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int,
    ]
    lib.pifpaf_load_batch_u8.restype = ctypes.c_int
    lib.pifpaf_load_batch_u8.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int,
    ]
    _lib = lib
    return _lib


def native_available():
    return _load_library() is not None


class NativeImageLoader:
    """Batched JPEG file loader producing normalized NHWC float32 batches.

    out shapes are computed from ``long_edge`` with pad-to-multiple
    (+1) like CenterPadTight, but anchored top-left so that no coordinate
    offset is introduced.
    """

    def __init__(self, *, long_edge=641, pad_multiple=16, n_threads=0):
        self.long_edge = long_edge
        self.pad_multiple = pad_multiple
        self.n_threads = n_threads
        self.lib = _load_library()
        if self.lib is None:
            raise RuntimeError('native io library unavailable')

    def _padded(self, v):
        m = self.pad_multiple
        return ((v - 1 + m - 1) // m) * m + 1

    def _load(self, fn, paths, dtype, c_type):
        n = len(paths)
        out_h = self._padded(self.long_edge)
        out_w = out_h
        images = np.zeros((n, out_h, out_w, 3), dtype=dtype)
        sizes = np.zeros((n, 4), dtype=np.int32)

        c_paths = (ctypes.c_char_p * n)(
            *[p.encode('utf-8') for p in paths])
        failures = fn(
            c_paths, n, self.long_edge, out_h, out_w,
            images.ctypes.data_as(ctypes.POINTER(c_type)),
            sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            self.n_threads)
        if failures:
            LOG.warning('%d images failed to load', failures)

        return images, self._metas(paths, sizes)

    def load_batch(self, paths):
        """Returns (images (N, H, W, 3) float32, metas list)."""
        return self._load(self.lib.pifpaf_load_batch, paths, np.float32,
                          ctypes.c_float)

    def load_batch_uint8(self, paths):
        """Like load_batch but returns raw uint8 pixels (no
        normalization): the float conversion + ImageNet normalization run
        on the device, and the host->device transfer is 4x smaller."""
        return self._load(self.lib.pifpaf_load_batch_u8, paths, np.uint8,
                          ctypes.c_ubyte)

    def _metas(self, paths, sizes):
        metas = []
        for i, path in enumerate(paths):
            scaled_h, scaled_w, orig_h, orig_w = (int(v) for v in sizes[i])
            scale = np.array((
                (scaled_w - 1) / max(1, orig_w - 1),
                (scaled_h - 1) / max(1, orig_h - 1),
            ))
            metas.append({
                'dataset_index': i,
                'file_name': path,
                'offset': np.array((0.0, 0.0)),
                'scale': scale,
                'rotation': {'angle': 0.0, 'width': None, 'height': None},
                'valid_area': np.array(
                    (0.0, 0.0, scaled_w - 1, scaled_h - 1)),
                'hflip': False,
                'width_height': np.array((orig_w, orig_h)),
                'scaled_wh': (scaled_w, scaled_h),
            })
        return metas
