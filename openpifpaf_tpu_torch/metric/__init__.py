"""Evaluation metrics: verbatim copies of the numpy modules ``base``,
``cocoeval``, ``coco`` and ``classification`` of ``openpifpaf_tpu/metric``."""

from .base import Base
from .coco import Coco
from .classification import Classification
