"""SamplePairing augmentation for image groups.

Semantics of reference ``transforms/pair/sample_pairing.py``: each frame
is alpha-blended 50/50 with the matching frame of the *previous* sample
and that sample's annotations are appended (Inoue 2018, arXiv:1801.02929,
adapted for pose estimation). The meta is left untouched: predictions map
back through the current sample's geometry. Stateful across calls by
design.
"""

import copy
import logging

import PIL.Image

from ..preprocess import Preprocess

LOG = logging.getLogger(__name__)


class SamplePairing(Preprocess):
    def __init__(self):
        self.previous_images = None
        self.previous_all_annotations = []

    def __call__(self, original_images, original_all_anns, metas):
        images = original_images
        all_anns = copy.deepcopy(original_all_anns)

        if self.previous_images is not None:
            images = [PIL.Image.blend(now, then, 0.5)
                      for now, then in zip(images, self.previous_images)]
            for frame_anns, extra in zip(all_anns,
                                         self.previous_all_annotations):
                frame_anns += extra

        self.previous_images = original_images
        self.previous_all_annotations = original_all_anns
        return images, all_anns, metas
