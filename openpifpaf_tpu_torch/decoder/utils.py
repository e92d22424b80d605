"""Compatibility aliases for the reference's ``decoder.utils`` namespace
(port of ``openpifpaf_tpu/decoder/utils.py``; reference
``decoder/utils/__init__.py:6-10``): the reference exposes its C++ stages
here; the port's equivalents are the ops in :mod:`openpifpaf_tpu_torch.ops`.
"""

from ..ops import cifhr, seeds, caf_scored, nms, grow

#: CifHr accumulation: ``cifhr.cif_hr(cif, stride) -> (F, HS, WS)``
CifHr = cifhr.cif_hr

#: seed extraction: ``seeds.cif_seeds(cif, hr, stride) -> dict``
CifSeeds = seeds.cif_seeds

#: association candidates: ``caf_scored.caf_scored(...)``
CafScored = caf_scored.caf_scored

#: keypoint-level NMS: ``nms.nms_keypoints(...)``
Keypoints = nms.nms_keypoints

#: connection blend kernel (reference grow_connection_blend)
grow_connection_blend = grow.grow_connection_blend
