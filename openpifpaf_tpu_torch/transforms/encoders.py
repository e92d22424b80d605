"""Terminal train-pipeline stage (semantics of reference
``transforms/encoders.py:4-12``): replaces the annotation dicts with the
encoded target tensors and records which head each target feeds."""

from .preprocess import Preprocess


class Encoders(Preprocess):
    def __init__(self, encoders):
        self.encoders = encoders

    def __call__(self, image, anns, meta):
        targets = [encode(image, anns, meta) for encode in self.encoders]
        meta['head_indices'] = [encode.meta.head_index
                                for encode in self.encoders]
        return image, targets, meta
