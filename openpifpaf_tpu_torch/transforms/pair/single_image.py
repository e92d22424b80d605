"""Frame-consistent application of single-image transforms (semantics of
reference ``transforms/pair/single_image.py:9-45``).

The reference forks the torch RNG per frame so that every frame sees the
same random draws; here the numpy RNG state is captured once and rewound
before each frame.
"""

import numpy as np

from ..preprocess import Preprocess


class SingleImage(Preprocess):
    def __init__(self, single_image_op):
        self.single_image_op = single_image_op

    def __call__(self, image_group, anns_group, meta_group):
        np.random.rand()  # advance so successive samples differ
        fork = np.random.get_state()

        out = []
        for frame in zip(image_group, anns_group, meta_group):
            np.random.set_state(fork)
            out.append(self.single_image_op(*frame))
        return tuple(list(column) for column in zip(*out))


class Ungroup(Preprocess):
    """Unwrap length-1 groups so eval looks like single-image data."""

    def __call__(self, image_group, anns_group, meta_group):
        assert len(image_group) == 1
        return image_group[0], anns_group[0], meta_group[0]
