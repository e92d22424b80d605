"""Configuration base class (copy of ``openpifpaf_tpu/configurable.py``).

The reference uses mutable class attributes set from argparse
(``configurable.py:4-50``); that pattern requires forked worker processes to
inherit config. Here config still lives in class attributes for CLI
compatibility, but every ``Configurable`` can also be constructed with
explicit keyword overrides, and ``asdict()`` serializes the effective config
so it can be passed to worker processes and checkpoints instead of
relying on process state.
"""

import argparse


class Configurable:
    def __init__(self, **kwargs):
        for key, value in kwargs.items():
            if not hasattr(self, key):
                raise ValueError(f'{key} not part of {type(self).__name__}')
            setattr(self, key, value)

    @classmethod
    def cli(cls, parser: argparse.ArgumentParser):
        """Extend an argparse parser with this class's options."""

    @classmethod
    def configure(cls, args: argparse.Namespace):
        """Apply parsed arguments to class attributes."""

    def asdict(self):
        return {
            k: getattr(self, k)
            for k in dir(type(self))
            if not k.startswith('_')
            and not callable(getattr(type(self), k, None))
            and not isinstance(getattr(type(self), k, None), property)
        }
