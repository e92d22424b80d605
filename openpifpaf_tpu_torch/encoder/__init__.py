"""Encoders: ground-truth annotations -> target fields for training
(copy of ``openpifpaf_tpu/encoder``, numpy only).

Runs on the host, in the data loader, as the JAX package's encoders do:
painted as batched scatters resolved by one nearest-writer sort per image
(see ``scatter.py``). Output layouts match the loss channel contract:
CIF (F, 5, H, W) [c, x, y, bmin, scale],
CAF and Tcaf (F, 9, H, W) [c, x1, y1, x2, y2, b1, b2, s1, s2],
CifDet (C, 7, H, W) [c, x, y, w, h, bmin_reg, bmin_wh].
``SingleImage`` runs a single-image encoder on the first frame of a
tracking pair; ``Tcaf`` paints the pair's cross-frame associations.
"""

from .annrescaler import AnnRescaler, AnnRescalerDet, TrackingAnnRescaler
from .caf import Caf
from .cif import Cif
from .cifdet import CifDet
from .factory import cli, configure
from .single_image import SingleImage
from .tcaf import Tcaf

__all__ = ['AnnRescaler', 'AnnRescalerDet', 'TrackingAnnRescaler', 'Caf',
           'Cif', 'CifDet', 'SingleImage', 'Tcaf', 'cli', 'configure']
