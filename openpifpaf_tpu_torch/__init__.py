"""openpifpaf_tpu_torch: the PyTorch/CUDA port of openpifpaf_tpu.

The port imports ``torch`` and numpy and never JAX. Importing this package
is cheap and imports nothing else: ``Predictor`` is resolved on first
access.
"""

__version__ = '0.1.0'


def __getattr__(name):
    if name == 'Predictor':
        from .predictor import Predictor
        return Predictor
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
