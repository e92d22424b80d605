"""Build and load of the port's CUDA kernels (``csrc/*.cu``).

Each source compiles on its own with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, in the build directory, and is loaded
with ``ctypes``. The build directory is by default the git-ignored
``_build/`` beside this file; ``--xla-compilation-cache DIR`` of every CLI
(:mod:`.compile_cache`) points it elsewhere, or at a temporary directory
of the process. A library is keyed on the source's bytes and the flags,
so an edited source or a changed flag builds anew and an unchanged one is
reused. Nothing is compiled at import: the first call of a kernel's
wrapper on a CUDA tensor builds its library. :func:`cached_build` also
builds the port's native JPEG loader (:mod:`.io.native`) with ``g++``.

    python -m openpifpaf_tpu_torch._nvcc depthwise.cu shuffle_block.cu

prints each kernel's registers and spills as ``ptxas -v`` reports them.
"""

import ctypes
import hashlib
import os
import re
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'csrc')
#: the build directory unless :func:`set_build_dir` chose another
DEFAULT_BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 '_build')
BUILD_DIR = DEFAULT_BUILD_DIR
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC')

_LIBS = {}
_LOCK = threading.Lock()


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError('nvcc not found: set CUDA_HOME to the CUDA '
                           'toolkit to build the port\'s kernels')
    return os.path.join(CUDA_HOME, 'bin', 'nvcc')


def set_build_dir(path):
    """Build and load the libraries in ``path`` from now on (libraries
    already loaded stay loaded)."""
    global BUILD_DIR
    BUILD_DIR = os.path.abspath(os.path.expanduser(path))


def cached_build(path, compiler, flags, libs=()):
    """Compile the source ``path`` with ``compiler() *flags -o LIB path
    *libs`` into the build directory, unless a library for these exact
    bytes, flags and libraries is there. Returns the library's path.
    ``compiler`` is called only for a build, so that a process that finds
    the library needs no compiler."""
    with open(path, 'rb') as f:
        digest = hashlib.sha256(
            f.read() + ' '.join((*flags, *libs)).encode())
    stem = os.path.splitext(os.path.basename(path))[0]
    lib_path = os.path.join(BUILD_DIR,
                            f'lib{stem}_{digest.hexdigest()[:16]}.so')
    if os.path.exists(lib_path):
        return lib_path
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
    except OSError as e:
        raise RuntimeError(
            f'cannot create the kernel build directory {BUILD_DIR} ({e}); '
            'choose a writable one with --xla-compilation-cache DIR, or '
            "'' for a temporary one") from e
    tmp = f'{lib_path}.{os.getpid()}.{threading.get_ident()}.tmp'
    cmd = [compiler(), *flags, '-o', tmp, path, *libs]
    done = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if done.returncode != 0:
        raise RuntimeError(f'{os.path.basename(cmd[0])} failed on '
                           f'{os.path.basename(path)} ({done.returncode}):\n'
                           f'{done.stdout}{done.stderr}')
    os.replace(tmp, lib_path)
    return lib_path


def build(source, csrc=CSRC):
    """Compile ``<csrc>/<source>`` (by default the port's ``csrc/``) with
    ``nvcc`` unless a library for this exact source and these flags
    exists. Returns the library's path."""
    return cached_build(os.path.join(csrc, source), _nvcc, NVCC_FLAGS)


def function(source, symbol, argtypes):
    """The C function ``symbol`` of ``csrc/<source>``, built and loaded at
    first use, with ``argtypes`` declared and an ``int`` (CUDA error)
    result."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            lib = _LIBS[source] = ctypes.CDLL(build(source))
        fn = getattr(lib, symbol)
        if fn.argtypes is None:
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
    return fn


def launch(fn, device, *args):
    """Call the kernel's C function with ``args`` and PyTorch's current
    stream on ``device`` as the last argument; raise if the launch failed
    (a refused launch never runs, and no synchronise would report it)."""
    import torch
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'{fn.__name__} launch failed: CUDA error {err}')


def ptxas_report(source):
    """``(kernel, registers, spill stores, spill loads)`` of each kernel of
    ``csrc/<source>``, from ``nvcc -Xptxas -v`` on a cubin with the
    library's flags (the cubin goes to ``_build/``)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    cubin = os.path.join(BUILD_DIR, f'{os.path.splitext(source)[0]}.cubin')
    flags = [f for f in NVCC_FLAGS if f not in ('-shared', '-Xcompiler',
                                                '-fPIC')]
    done = subprocess.run(
        [_nvcc(), *flags, '-cubin', '-Xptxas', '-v', '-o', cubin,
         os.path.join(CSRC, source)], capture_output=True, text=True,
        check=False)
    if done.returncode != 0:
        raise RuntimeError(f'nvcc failed on {source}:\n{done.stderr}')
    rows, name, spills = [], None, (0, 0)
    for line in (done.stdout + done.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r'Used (\d+) registers', line)
        if m and name:
            rows.append((name, int(m.group(1))) + spills)
            name, spills = None, (0, 0)
    demangle = os.path.join(os.path.dirname(_nvcc()), 'cu++filt')
    if os.path.exists(demangle):
        names = subprocess.run(
            [demangle], input='\n'.join(r[0] for r in rows),
            capture_output=True, text=True, check=False).stdout.splitlines()
        if len(names) == len(rows):
            rows = [(n,) + r[1:] for n, r in zip(names, rows)]
    return rows


def main(sources):
    with ThreadPoolExecutor(len(sources)) as pool:
        for source, rows in zip(sources, pool.map(ptxas_report, sources)):
            for name, regs, stores, loads in rows:
                print(f'{source}: {name}: {regs} registers, spill stores '
                      f'{stores} B, spill loads {loads} B')


if __name__ == '__main__':
    main(sys.argv[1:])
