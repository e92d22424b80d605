"""Debug visualizers for intermediate fields (copy of
``openpifpaf_tpu/visualizer``). They draw numpy arrays: a caller holding
tensors moves them to the host first."""

from .base import Base
from .fields_vis import (Cif, Caf, CifHr, CifDet, Seeds, Occupancy,
                         Tcaf, MultiTracking)
from .cli import cli, configure
