"""DataModule ABC (copy of ``openpifpaf_tpu/datasets/module.py``).

A data module owns head metas and provides train/val/eval loaders. Loaders
yield host-side numpy batches; the trainer moves them to the device.
"""

import argparse


class DataModule:
    """Base class for datasets."""

    batch_size = 1
    loader_workers = 0

    #: set by subclass constructors
    head_metas = None

    @classmethod
    def cli(cls, parser: argparse.ArgumentParser):
        """Command line interface (CLI) to extend argument parser."""

    @classmethod
    def configure(cls, args: argparse.Namespace):
        """Take the parsed argument parser output and configure class variables."""

    def metrics(self):
        """Return a list of metrics for eval."""
        raise NotImplementedError

    def train_loader(self):
        raise NotImplementedError

    def val_loader(self):
        raise NotImplementedError

    def eval_loader(self):
        raise NotImplementedError
