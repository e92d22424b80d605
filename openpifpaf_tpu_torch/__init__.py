"""openpifpaf_tpu_torch: the PyTorch/CUDA port of openpifpaf_tpu.

The port imports ``torch`` and numpy and never JAX. Importing this package
is cheap and imports nothing else: ``Predictor`` and the checkpoint
registry (``CHECKPOINT_URLS``, ``PRETRAINED_UNAVAILABLE``) are resolved on
first access.
"""

__version__ = '0.1.0'


def __getattr__(name):
    if name == 'Predictor':
        from .predictor import Predictor
        return Predictor
    if name in ('CHECKPOINT_URLS', 'PRETRAINED_UNAVAILABLE'):
        from .models import factory
        return getattr(factory, name)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
