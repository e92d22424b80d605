"""Past-frame replacement augmentations (semantics of reference
``transforms/pair/blank_past.py``). All three variants overwrite every
frame after the first; they differ in what the replacement is."""

import copy

import numpy as np
import PIL.Image

from ..preprocess import Preprocess


def _gray_frame():
    return PIL.Image.new('RGB', (320, 240), (127, 127, 127))


def _replace_past(images, all_anns, metas, *, image, anns, image_meta):
    """Every frame but the first becomes the given replacement."""
    images = list(images)
    all_anns = copy.deepcopy(all_anns)
    metas = copy.deepcopy(metas)
    for i in range(1, len(images)):
        images[i] = image
    for i in range(1, len(all_anns)):
        all_anns[i] = copy.deepcopy(anns)
    for meta in metas[1:]:
        meta['image'] = image_meta
    return images, all_anns, metas


class BlankPast(Preprocess):
    """Past frames become uniform gray with no annotations."""

    def __call__(self, images, all_anns, metas):
        return _replace_past(
            images, all_anns, metas,
            image=_gray_frame(), anns=[],
            image_meta={'frame_id': -1, 'file_name': 'blank'})


class PreviousPast(Preprocess):
    """Past frames show the previous sample's pixels (uncorrelated
    negative pairs) with no annotations. Stateful across calls by design.
    """

    def __init__(self):
        self.previous_image = _gray_frame()
        self.previous_meta = {'frame_id': -1, 'file_name': 'blank'}
        self.previous_annotations = []

    def __call__(self, images, all_anns, metas):
        images, all_anns, metas = _replace_past(
            images, all_anns, metas,
            image=self.previous_image, anns=[],
            image_meta=self.previous_meta)
        self.previous_image = images[0]
        self.previous_annotations = all_anns[0]
        self.previous_meta = metas[0]
        return images, all_anns, metas


class RandomizeOneFrame(Preprocess):
    """Replace one random frame with a cached frame from another sample
    (negative pairs for association training); the replacement's track
    ids are offset so they never match."""

    def __init__(self):
        self.previous_image = None
        self.previous_meta = None
        self.previous_annotations = []

    def __call__(self, images, all_anns, metas):
        images = list(images)
        all_anns = copy.deepcopy(all_anns)
        metas = copy.deepcopy(metas)

        replaced = int(np.random.randint(0, len(metas)))
        if self.previous_image is not None:
            images[replaced] = self.previous_image
            all_anns[replaced] = self.previous_annotations
            for ann in all_anns[replaced]:
                ann['track_id'] = ann.get('track_id', 0) + 10000
            metas[replaced] = self.previous_meta

        keep = 1 if replaced == 0 else 0
        self.previous_image = copy.deepcopy(images[keep])
        self.previous_annotations = copy.deepcopy(all_anns[keep])
        self.previous_meta = copy.deepcopy(metas[keep])
        return images, all_anns, metas
