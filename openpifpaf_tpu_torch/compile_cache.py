"""The build directory of the port's native libraries (port of
``openpifpaf_tpu/compile_cache.py``).

JAX keeps XLA's compiled programs in a persistent cache so that a second
process loads them instead of compiling again. The port compiles no
program at run time; what it compiles, and keeps for the next process, are
its hand-written CUDA kernels (``nvcc``, :mod:`._nvcc`) and its native
JPEG loader (``g++``, :mod:`.io.native`). So here the flag keeps JAX's
name, ``--xla-compilation-cache DIR``, and sets the directory those
libraries are built into and loaded from. The default is the git-ignored
``_build/`` beside the package; ``''`` means, as in JAX, no persistent
cache: the process builds into a temporary directory of its own, removed
at exit. Point it elsewhere where the installed package is read-only.

Wired into every CLI entry point through ``logger.cli`` and
``logger.configure``.
"""

import atexit
import logging
import shutil
import tempfile

from . import _nvcc

LOG = logging.getLogger(__name__)

DEFAULT_DIR = _nvcc.DEFAULT_BUILD_DIR


def cli(parser):
    group = parser.add_argument_group('compilation cache')
    group.add_argument('--xla-compilation-cache', default=DEFAULT_DIR,
                       metavar='DIR',
                       help='directory the CUDA kernels and the native '
                            'JPEG loader are built into and loaded from '
                            '(in the port this is the kernel build '
                            'directory, not XLA\'s compilation cache); '
                            "'' builds into a temporary directory of this "
                            'process')


def configure(args):
    enable(getattr(args, 'xla_compilation_cache', DEFAULT_DIR))


def enable(cache_dir=DEFAULT_DIR):
    """Build the port's libraries into ``cache_dir``; a falsy dir builds
    into a fresh temporary directory, removed when the process exits.
    Returns True for a persistent cache."""
    if not cache_dir:
        cache_dir = tempfile.mkdtemp(prefix='openpifpaf_tpu_torch-build-')
        atexit.register(shutil.rmtree, cache_dir, ignore_errors=True)
        _nvcc.set_build_dir(cache_dir)
        LOG.debug('kernel build directory (this process only): %s',
                  cache_dir)
        return False
    _nvcc.set_build_dir(cache_dir)
    LOG.debug('kernel build directory: %s', _nvcc.BUILD_DIR)
    return True
