"""Training: losses, optimizer schedules, trainer, checkpoints (port of
``openpifpaf_tpu/training``)."""

from . import losses
from .losses import (LOSSES, CompositeLoss, MultiHeadLoss,
                     MultiHeadLossAutoTuneKendall,
                     MultiHeadLossAutoTuneVariance)
