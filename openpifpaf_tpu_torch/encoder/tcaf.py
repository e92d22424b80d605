"""Tcaf target painter: cross-frame associations for tracking (copy of
``openpifpaf_tpu/encoder/tcaf.py``).

A CAF band painted between the two frames of each track (reference
``encoder/tcaf.py:13-43``). Reuses the CAF painter wholesale — the only
differences are the pair-aware rescaler (keypoint sets are per-track
concatenations of frame-1 and frame-2 joints), the cross-frame skeleton
baked into the Tcaf headmeta, and fixed-size bands (one ``min_size``²
stamp at each segment midpoint).
"""

import dataclasses
from typing import ClassVar

from .annrescaler import TrackingAnnRescaler
from .caf import Caf, paint_caf
from .. import headmeta


@dataclasses.dataclass
class Tcaf(Caf):
    meta: headmeta.Tcaf = None

    # independent of Caf's CLI-configured values
    min_size: ClassVar[int] = 3
    fixed_size: ClassVar[bool] = True
    aspect_ratio: ClassVar[float] = 0.0
    padding: ClassVar[int] = 10

    def __post_init__(self):
        if self.rescaler is None:
            self.rescaler = TrackingAnnRescaler(self.meta.stride,
                                                self.meta.pose)
        super().__post_init__()

    def __call__(self, images, all_anns, metas):
        # both frames share the geometry of frame 1
        return paint_caf(self, self.rescaler, images[0].shape[1::-1],
                         all_anns, metas)
