"""Evaluation metrics: verbatim copies of the numpy modules ``base``,
``cocoeval`` and ``coco`` of ``openpifpaf_tpu/metric`` (``classification``
waits for Cifar10, ROADMAP A9)."""

from .base import Base
from .coco import Coco
