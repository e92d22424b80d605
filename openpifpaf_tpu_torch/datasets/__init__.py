"""Datasets: DataModule contract, registry and loaders (copy of
``openpifpaf_tpu/datasets``)."""

from .module import DataModule
from .factory import DATAMODULES, datamodules, factory
from .image_list import ImageList, NumpyImageList, PilImageList
from .loader import Loader
from .loader_with_reset import LoaderWithReset
from .multiloader import MultiLoader
from .multimodule import ConcatenatedLists, MultiDataModule
from .wrapped import WrappedDataset
from . import collate
