"""Datasets over images in memory or on disk, for the Predictor (copy of
``openpifpaf_tpu/datasets/image_list.py``). The three variants differ only
in how an item becomes a PIL image; the preprocessing and the
(raw, processed, anns, meta) packaging are shared."""

import numpy as np
import PIL.Image


class _ImageSource:
    """Sequence of (processed_image, anns, meta) samples; subclasses
    provide the raw PIL image and the per-item meta."""

    def __init__(self, sources, preprocess=None, with_raw_image=False):
        self.sources = sources
        self.preprocess = preprocess
        self.with_raw_image = with_raw_image

    def __len__(self):
        return len(self.sources)

    def load(self, source):
        raise NotImplementedError

    def meta(self, index):
        return {'dataset_index': index}

    def __getitem__(self, index):
        raw = self.load(self.sources[index])
        sample = self.preprocess(raw, [], self.meta(index))
        return (raw, *sample) if self.with_raw_image else sample


class ImageList(_ImageSource):
    """Images addressed by file path."""

    def load(self, source):
        with open(source, 'rb') as f:
            return PIL.Image.open(f).convert('RGB')

    def meta(self, index):
        return {'dataset_index': index, 'file_name': self.sources[index]}


class PilImageList(_ImageSource):
    """Already-open PIL images."""

    def load(self, source):
        return source.copy().convert('RGB')


class NumpyImageList(_ImageSource):
    """Images as HxWx3 numpy arrays."""

    def load(self, source):
        return PIL.Image.fromarray(np.asarray(source))
