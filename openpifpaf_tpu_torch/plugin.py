"""Plugin discovery (copy of ``openpifpaf_tpu/plugin.py``).

Imports every ``openpifpaf_tpu_torch.plugins.*`` submodule and every
installed top-level package named ``openpifpaf_tpu_torch_*`` and calls its
``register()``, once, when the dataset registry is first read
(``datasets.datamodules()``). The trailing underscore of the prefix keeps
the port itself out, and the JAX package's ``openpifpaf_tpu_*`` plugins.
"""

import importlib
import logging
import pkgutil

LOG = logging.getLogger(__name__)

PREFIX = 'openpifpaf_tpu_torch_'

REGISTERED = {}
_DONE = False


def register():
    global _DONE  # pylint: disable=global-statement
    if _DONE:
        return
    from . import plugins

    for _, name, _ in pkgutil.iter_modules(plugins.__path__,
                                           plugins.__name__ + '.'):
        module = importlib.import_module(name)
        if hasattr(module, 'register'):
            module.register()
            REGISTERED[name] = module

    for _, name, _ in pkgutil.iter_modules():
        if not name.startswith(PREFIX):
            continue
        try:
            module = importlib.import_module(name)
        except ImportError as e:
            LOG.warning('could not import plugin %s: %s', name, e)
            continue
        if hasattr(module, 'register'):
            module.register()
            REGISTERED[name] = module
    _DONE = True


def versions():
    return {
        name: getattr(module, '__version__', 'unknown')
        for name, module in REGISTERED.items()
    }
