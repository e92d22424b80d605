"""Wrap a generic classification-style parent dataset (copy of
``openpifpaf_tpu/datasets/wrapped.py``).

The parent is any indexable returning raw per-sample data (e.g. ``(PIL
image, label)`` tuples); the preprocess pipeline turns it into (image,
anns, meta).
"""

import logging

from .. import transforms

LOG = logging.getLogger(__name__)


class WrappedDataset:
    """Applies the framework preprocess pipeline to a parent dataset."""

    def __init__(self, parent, *, preprocess=None):
        self.parent = parent
        self.preprocess = preprocess or transforms.EVAL_TRANSFORM

    def __getitem__(self, index):
        parent_data = self.parent[index]
        # classification-style parents return (image, label) tuples
        image = parent_data[0] if isinstance(parent_data, (tuple, list)) \
            else parent_data

        meta = {'dataset_index': index}
        image, anns, meta = self.preprocess(image, [], meta)
        LOG.debug(meta)
        return image, anns, meta

    def __len__(self):
        return len(self.parent)
