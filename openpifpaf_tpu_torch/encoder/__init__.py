"""Encoders: ground-truth annotations -> target fields for training
(copy of ``openpifpaf_tpu/encoder``, numpy only).

Runs on the host, in the data loader, as the JAX package's encoders do:
painted as batched scatters resolved by one nearest-writer sort per image
(see ``scatter.py``). Output layouts match the loss channel contract:
CIF (F, 5, H, W) [c, x, y, bmin, scale],
CAF (F, 9, H, W) [c, x1, y1, x2, y2, b1, b2, s1, s2].
The CifDet and tracking encoders are not ported yet (ROADMAP A9, A10).
"""

from .annrescaler import AnnRescaler
from .caf import Caf
from .cif import Cif
from .factory import cli, configure

__all__ = ['AnnRescaler', 'Caf', 'Cif', 'cli', 'configure']
