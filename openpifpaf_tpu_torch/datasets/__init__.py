"""Datasets: DataModule contract, registry and loaders (copy of the
parts of ``openpifpaf_tpu/datasets`` that single-dataset training and
eval use)."""

from .module import DataModule
from .factory import DATAMODULES, datamodules, factory
from .loader import Loader
from .loader_with_reset import LoaderWithReset
from .wrapped import WrappedDataset
from . import collate
