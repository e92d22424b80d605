"""Preprocessing transforms (image, anns, meta) -> (image, anns, meta)
(copy of ``openpifpaf_tpu/transforms``, numpy and PIL only).

Images are PIL images until :data:`EVAL_TRANSFORM` or
:data:`TRAIN_TRANSFORM` turns them into normalized (H, W, 3) float32
arrays. Geometric steps update both the annotations and the meta
(offset/scale/rotation/valid_area) so that
``Annotation.inverse_transform(meta)`` maps predictions back to the
original image coordinates. The random transforms draw from the global
``np.random`` in the JAX package's order, so that a seeded run gives the
same samples in both packages.
"""

from .preprocess import Preprocess
from . import pair
from .compose import Compose
from .annotations import NormalizeAnnotations, AnnotationJitter
from .scale import RescaleAbsolute, RescaleRelative, ScaleMix
from .pad import CenterPad, CenterPadTight, SquarePad
from .crop import Crop
from .hflip import HFlip
from .image import ImageTransform, Blur, HorizontalBlur, JpegCompression
from .random import RandomApply, RandomChoice, DeterministicEqualChoice
from .rotate import RotateBy90, RotateUniform
from .toannotations import (ToAnnotations, ToKpAnnotations, ToDetAnnotations,
                            ToCrowdAnnotations)
from .encoders import Encoders
from .normalize import (EVAL_TRANSFORM, TRAIN_TRANSFORM, NormalizeImage,
                        ToNumpy, IMAGENET_MEAN, IMAGENET_STD,
                        IMAGENET_MEAN_U8)
