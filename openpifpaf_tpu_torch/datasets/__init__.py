"""Datasets: DataModule contract, registry and loaders (copy of the
parts of ``openpifpaf_tpu/datasets`` that single-dataset training and
eval use)."""

from .module import DataModule
from .factory import datamodules, factory
from .loader import Loader
from .loader_with_reset import LoaderWithReset
from . import collate
