"""Image normalization to NHWC numpy float32.

The reference uses torchvision ToTensor + ImageNet Normalize
(``transforms/__init__.py:26-44``); here images become (H, W, 3) float32
arrays, the channel-last layout that the port's models take.
"""

import numpy as np

from .annotations import NormalizeAnnotations
from .compose import Compose
from .image import ColorJitter, JpegCompression, RandomGrayscale
from .preprocess import Preprocess
from .random import RandomApply

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)
#: the mean as uint8 pixels — the pad fill color that normalizes to ~0
IMAGENET_MEAN_U8 = tuple(int(round(float(m) * 255)) for m in IMAGENET_MEAN)


class ToNumpy(Preprocess):
    def __call__(self, image, anns, meta):
        image = np.asarray(image, dtype=np.float32) / 255.0
        return image, anns, meta


class NormalizeImage(Preprocess):
    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.mean = mean
        self.std = std

    def __call__(self, image, anns, meta):
        image = (np.asarray(image, dtype=np.float32) - self.mean) / self.std
        return image, anns, meta


EVAL_TRANSFORM = Compose([
    NormalizeAnnotations(),
    ToNumpy(),
    NormalizeImage(),
])


TRAIN_TRANSFORM = Compose([
    NormalizeAnnotations(),
    ColorJitter(brightness=0.4, contrast=0.1, saturation=0.4, hue=0.1),
    RandomApply(JpegCompression(), 0.1),
    RandomGrayscale(p=0.01),
    ToNumpy(),
    NormalizeImage(),
])
