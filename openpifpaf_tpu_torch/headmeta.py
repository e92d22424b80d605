"""Head metadata (port of ``openpifpaf_tpu/headmeta.py``: ``Base``, ``Cif``,
``Caf``, the detection meta ``CifDet`` and the tracking metas
``TSingleImageCif``, ``TSingleImageCaf`` and ``Tcaf``): the schema
contract shared by heads and decoders.

Mirrors the semantics of the reference ``openpifpaf/headmeta.py:37-187``:
a head meta describes the *composition* of a composite field (how many
confidences, regression vectors and scales each field has), plus dataset
specific information (keypoint names, skeleton, sigmas, ...).

Everything downstream dispatches on these dataclasses:
datasets construct them, the network factory builds one head per meta,
the loss factory builds one composite loss per meta, and the decoder
factory pairs (Cif, Caf) metas into decode pipelines and gives each
CifDet meta its detection decoder.
"""

from dataclasses import dataclass, field
from typing import Any, ClassVar, List, Optional, Tuple

import numpy as np


@dataclass
class Base:
    name: str
    dataset: str

    head_index: Optional[int] = field(default=None, init=False)
    base_stride: Optional[int] = field(default=None, init=False)
    upsample_stride: int = field(default=1, init=False)

    n_confidences: ClassVar[int] = 1
    n_vectors: ClassVar[int] = 1
    n_scales: ClassVar[int] = 1
    vector_offsets: ClassVar[List[bool]] = [True]

    @property
    def stride(self) -> Optional[int]:
        if self.base_stride is None:
            return None
        return self.base_stride // self.upsample_stride

    @property
    def n_fields(self) -> int:
        raise NotImplementedError

    @property
    def n_components(self) -> int:
        """Channels per field in the CompositeField4 layout:
        1 width/logb + confidences + 2 per vector + scales."""
        return 1 + self.n_confidences + self.n_vectors * 2 + self.n_scales


@dataclass
class Cif(Base):
    """Composite Intensity Field: one field per keypoint type.

    Decoded field channels (after head postprocessing):
    [logb, confidence, x, y, scale] (reference ``csrc/src/cif_hr.cpp:38-45``).
    """

    keypoints: List[str] = None
    sigmas: List[float] = None
    pose: Any = None
    draw_skeleton: Optional[List[Tuple[int, int]]] = None
    score_weights: Optional[List[float]] = None

    n_confidences: ClassVar[int] = 1
    n_vectors: ClassVar[int] = 1
    n_scales: ClassVar[int] = 1
    vector_offsets: ClassVar[List[bool]] = [True]

    decoder_min_scale: float = 0.0
    decoder_seed_mask: Optional[List[int]] = None

    training_weights: Optional[List[float]] = None

    @property
    def n_fields(self) -> int:
        return len(self.keypoints)


@dataclass
class Caf(Base):
    """Composite Association Field: one field per skeleton edge.

    Decoded field channels:
    [logb, confidence, x1, y1, x2, y2, s1, s2]
    (reference ``csrc/src/caf_scored.cpp:43-54``).
    """

    keypoints: List[str] = None
    sigmas: List[float] = None
    skeleton: List[Tuple[int, int]] = None
    pose: Any = None
    sparse_skeleton: Optional[List[Tuple[int, int]]] = None
    dense_to_sparse_radius: float = 2.0
    only_in_field_of_view: bool = False

    n_confidences: ClassVar[int] = 1
    n_vectors: ClassVar[int] = 2
    n_scales: ClassVar[int] = 2
    vector_offsets: ClassVar[List[bool]] = [True, True]

    decoder_min_distance: float = 0.0
    decoder_max_distance: float = float('inf')
    decoder_confidence_scales: Optional[List[float]] = None

    training_weights: Optional[List[float]] = None

    @property
    def n_fields(self) -> int:
        return len(self.skeleton)

    @staticmethod
    def concatenate(metas):
        """One Caf meta for the fields of ``metas`` stacked along the edge
        axis (the dense decoder's sparse + dense CAF), with the first
        meta's head index and strides; a meta without confidence scales
        contributes scales of 1.0."""
        concatenated = Caf(
            name='_'.join(m.name for m in metas),
            dataset=metas[0].dataset,
            keypoints=metas[0].keypoints,
            sigmas=metas[0].sigmas,
            pose=metas[0].pose,
            skeleton=[s for meta in metas for s in meta.skeleton],
            sparse_skeleton=metas[0].sparse_skeleton,
            only_in_field_of_view=metas[0].only_in_field_of_view,
            decoder_confidence_scales=[
                s
                for meta in metas
                for s in (meta.decoder_confidence_scales
                          if meta.decoder_confidence_scales
                          else [1.0 for _ in meta.skeleton])
            ],
        )
        concatenated.head_index = metas[0].head_index
        concatenated.base_stride = metas[0].base_stride
        concatenated.upsample_stride = metas[0].upsample_stride
        return concatenated


@dataclass
class CifDet(Base):
    """Composite Intensity Field for detection: one field per category.

    Decoded field channels: [logb, confidence, x, y, w, h].
    """

    categories: List[str] = None

    n_confidences: ClassVar[int] = 1
    n_vectors: ClassVar[int] = 2
    n_scales: ClassVar[int] = 0
    vector_offsets: ClassVar[List[bool]] = [True, False]

    decoder_min_scale: float = 0.0

    training_weights: Optional[List[float]] = None

    @property
    def n_fields(self) -> int:
        return len(self.categories)


@dataclass
class TSingleImageCif(Cif):
    """Single-image CIF head in tracking models."""


@dataclass
class TSingleImageCaf(Caf):
    """Single-image CAF head in tracking models."""


@dataclass
class Tcaf(Base):
    """Tracking Composite Association Field (cross-frame associations)."""

    keypoints_single_frame: List[str] = None
    sigmas_single_frame: List[float] = None
    pose_single_frame: Any = None
    draw_skeleton_single_frame: Optional[List[Tuple[int, int]]] = None
    keypoints: Optional[List[str]] = None
    sigmas: Optional[List[float]] = None
    pose: Any = None
    draw_skeleton: Optional[List[Tuple[int, int]]] = None
    only_in_field_of_view: bool = False

    n_confidences: ClassVar[int] = 1
    n_vectors: ClassVar[int] = 2
    n_scales: ClassVar[int] = 2
    vector_offsets: ClassVar[List[bool]] = [True, True]

    training_weights: Optional[List[float]] = None

    def __post_init__(self):
        if self.keypoints is None:
            self.keypoints = self.keypoints_single_frame + self.keypoints_single_frame
        if self.sigmas is None:
            self.sigmas = list(self.sigmas_single_frame) + list(self.sigmas_single_frame)
        if self.pose is None and self.pose_single_frame is not None:
            self.pose = np.concatenate(
                (self.pose_single_frame, self.pose_single_frame), axis=0)
        if self.draw_skeleton is None and self.draw_skeleton_single_frame is not None:
            self.draw_skeleton = (self.draw_skeleton_single_frame
                                  + self.draw_skeleton_single_frame)

    @property
    def skeleton(self):
        return [(i + 1, i + 1 + len(self.keypoints_single_frame))
                for i, _ in enumerate(self.keypoints_single_frame)]

    @property
    def n_fields(self) -> int:
        return len(self.keypoints_single_frame)
