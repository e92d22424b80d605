"""Visualization of annotations with matplotlib (copy of
``openpifpaf_tpu/show``): painters, canvases, field primitives, the video
frame writer and the ``--show-*`` flags. matplotlib is optional: every
module imports without it, and drawing without it raises ``ImportError``.
"""

from .painters import (KeypointPainter, DetectionPainter, CrowdPainter,
                       AnnotationPainter)
from .canvas import Canvas, annotation_canvas, image_canvas, canvas
from .animation_frame import AnimationFrame, VirtualCamWriter
from . import fields
from .fields import white_screen, quiver, boxes, circles
from .cli import cli, configure

PAINTERS = {
    'Annotation': KeypointPainter,
    'AnnotationDet': DetectionPainter,
    'AnnotationCrowd': CrowdPainter,
}
