"""Transforms for image pairs (tracking training): copies of
``openpifpaf_tpu/transforms/pair``, numpy and PIL only. The random ones
draw from the global ``np.random`` in the JAX package's order."""

from .single_image import SingleImage, Ungroup
from .image_to_tracking import ImageToTracking
from .camera_shift import CameraShift
from .crop import Crop
from .pad import Pad
from .encoders import Encoders
from .blank_past import BlankPast, PreviousPast, RandomizeOneFrame
from .sample_pairing import SamplePairing
