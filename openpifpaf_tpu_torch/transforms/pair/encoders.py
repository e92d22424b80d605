"""Terminal train-pipeline stage for pair groups (semantics of reference
``transforms/pair/encoders.py``): pair encoders see the whole group and
the sample collapses to frame 1's meta."""

from ..preprocess import Preprocess


class Encoders(Preprocess):
    def __init__(self, encoders):
        self.encoders = encoders

    def __call__(self, images, all_anns, metas):
        targets = [encode(images, all_anns, metas)
                   for encode in self.encoders]
        lead_meta = metas[0]
        lead_meta['head_indices'] = [encode.meta.head_index
                                     for encode in self.encoders]
        return images, targets, lead_meta
