"""Stochastic transform selection (semantics of reference
``transforms/random.py``)."""

import numpy as np

from .preprocess import Preprocess


class RandomApply(Preprocess):
    def __init__(self, transform, probability):
        self.transform = transform
        self.probability = probability

    def __call__(self, image, anns, meta):
        if float(np.random.rand()) > self.probability:
            return image, anns, meta
        return self.transform(image, anns, meta)


class RandomChoice(Preprocess):
    """Pick one transform by the given probabilities; an implicit ``None``
    (identity) entry absorbs any leftover probability mass."""

    def __init__(self, transforms, probabilities):
        transforms = list(transforms)
        probabilities = list(probabilities)
        if sum(probabilities) < 1.0 and len(transforms) == len(probabilities):
            transforms.append(None)
        if len(transforms) == len(probabilities) + 1:
            probabilities.append(1.0 - sum(probabilities))
        assert len(transforms) == len(probabilities)
        assert abs(sum(probabilities) - 1.0) < 1e-6

        self.transforms = transforms
        self.cumulative = np.cumsum(probabilities)

    def __call__(self, image, anns, meta):
        draw = float(np.random.rand())
        index = int(np.searchsorted(self.cumulative, draw))
        chosen = (self.transforms[index]
                  if index < len(self.transforms) else None)
        if chosen is None:
            return image, anns, meta
        return chosen(image, anns, meta)


class DeterministicEqualChoice(Preprocess):
    """Choose a transform deterministically from meta['image_id'] + salt
    (stable across epochs; used for multi-scale eval)."""

    def __init__(self, transforms, salt=0):
        self.transforms = transforms
        self.salt = salt

    def __call__(self, image, anns, meta):
        assert meta.get('image_id') is not None
        choice = hash(meta['image_id'] + self.salt) % len(self.transforms)
        chosen = self.transforms[choice]
        if chosen is None:
            return image, anns, meta
        return chosen(image, anns, meta)
