"""openpifpaf_tpu_torch: the PyTorch/CUDA port of openpifpaf_tpu.

The port imports ``torch`` and numpy and never JAX. Importing this package
imports ``torch`` and no other module of the package: ``Predictor`` and
the checkpoint registry (``CHECKPOINT_URLS``, ``PRETRAINED_UNAVAILABLE``)
are resolved on first access. It registers the port's one PyTorch
operator, ``torch.ops.openpifpaf_tpu_torch.cifhr_accumulate`` (the CifHr
kernel, :func:`.ops.cifhr_cuda.accumulate`), so that a program that
``export`` wrote with the decoder loads and runs in a process that has
imported this package.
"""

import torch

__version__ = '0.1.0'


#: the CifHr kernel as a PyTorch operator, defined through the dispatcher
#: (``torch.library.custom_op``'s wrapper imports hundreds of modules at
#: its first call, seconds in every process that decodes)
_CIFHR = 'openpifpaf_tpu_torch::cifhr_accumulate'
torch.library.define(_CIFHR, '(Tensor x, Tensor y, Tensor sigma, Tensor w, '
                     'int hr_h, int hr_w, float neighbors, float factor) '
                     '-> Tensor')


@torch.library.impl(_CIFHR, 'CPU')
def _cifhr_accumulate_cpu(x, y, sigma, w, hr_h, hr_w, neighbors, factor):
    """The CifHr map (F, hr_h, hr_w) of (F, K) float32 cells: the plain
    version on the CPU, the CUDA kernel on the card."""
    from .ops import cifhr
    return cifhr.accumulate_dense(x, y, sigma, w, hr_h=hr_h, hr_w=hr_w,
                                  neighbors=neighbors, factor=factor)


@torch.library.impl(_CIFHR, 'CUDA')
def _cifhr_accumulate_cuda(x, y, sigma, w, hr_h, hr_w, neighbors, factor):
    from .ops import cifhr_cuda
    return cifhr_cuda.launch_counted(x, y, sigma, w, hr_h=hr_h, hr_w=hr_w,
                                     neighbors=neighbors, factor=factor)


@torch.library.register_fake(_CIFHR)
def _cifhr_accumulate_fake(x, y, sigma, w, hr_h, hr_w, neighbors, factor):
    return x.new_empty((x.shape[0], hr_h, hr_w), dtype=torch.float32)


def __getattr__(name):
    if name == 'Predictor':
        from .predictor import Predictor
        return Predictor
    if name in ('CHECKPOINT_URLS', 'PRETRAINED_UNAVAILABLE'):
        from .models import factory
        return getattr(factory, name)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
