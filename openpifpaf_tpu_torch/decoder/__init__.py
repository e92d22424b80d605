"""Decoders of the port (counterparts of ``openpifpaf_tpu/decoder``).

``factory(head_metas)`` gives the ``Multi`` of every decoder that the head
metas admit, as ``openpifpaf_tpu.decoder.factory.factory`` does; ``cli``
and ``configure`` are the registry's flags.
"""

from .base import Decoder
from .cifcaf import CifCaf, CifCafDense
from .cifdet import CifDet
from .multi import Multi
from .track_annotation import TrackAnnotation
from .track_base import TrackBase
from .tracking_pose import TrackingPose
from .pose_similarity import PoseSimilarity
from . import pose_distance
from .factory import DECODERS, cli, configure, decoders, factory
