"""Image-only transforms (reference ``transforms/image.py``)."""

import io
import logging

import numpy as np
import PIL.Image
import PIL.ImageEnhance
import PIL.ImageFilter

from .preprocess import Preprocess

LOG = logging.getLogger(__name__)


class ImageTransform(Preprocess):
    """Apply a callable to the image only."""

    def __init__(self, image_transform):
        self.image_transform = image_transform

    def __call__(self, image, anns, meta):
        return self.image_transform(image), anns, meta


class JpegCompression(Preprocess):
    def __init__(self, quality=50):
        self.quality = quality

    def __call__(self, image, anns, meta):
        f = io.BytesIO()
        image.save(f, 'jpeg', quality=self.quality)
        return PIL.Image.open(f), anns, meta


class Blur(Preprocess):
    def __init__(self, max_sigma=5.0):
        self.max_sigma = max_sigma

    def __call__(self, image, anns, meta):
        im_np = np.asarray(image)
        sigma = self.max_sigma * float(np.random.rand())
        image = PIL.Image.fromarray(im_np).filter(
            PIL.ImageFilter.GaussianBlur(radius=sigma))
        return image, anns, meta


class HorizontalBlur(Preprocess):
    """Motion-blur horizontally (reference transforms/image.py)."""

    def __init__(self, max_sigma=5.0):
        self.max_sigma = max_sigma

    def __call__(self, image, anns, meta):
        im_np = np.asarray(image).astype(np.float32)
        sigma = self.max_sigma * float(np.random.rand())
        radius = max(1, int(2 * sigma))
        kernel = np.exp(
            -0.5 * (np.arange(-radius, radius + 1) / max(sigma, 0.1)) ** 2)
        kernel /= kernel.sum()
        blurred = np.stack([
            np.apply_along_axis(
                lambda row: np.convolve(row, kernel, mode='same'),
                1, im_np[:, :, c])
            for c in range(im_np.shape[2])
        ], axis=2)
        image = PIL.Image.fromarray(
            np.clip(blurred, 0, 255).astype(np.uint8))
        return image, anns, meta


class ColorJitter(Preprocess):
    """PIL-based color jitter (brightness/contrast/saturation/hue)."""

    def __init__(self, brightness=0.4, contrast=0.1, saturation=0.4, hue=0.1):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    def __call__(self, image, anns, meta):
        ops = []
        if self.brightness:
            f = 1.0 + np.random.uniform(-self.brightness, self.brightness)
            ops.append(lambda im: PIL.ImageEnhance.Brightness(im).enhance(f))
        if self.contrast:
            f_c = 1.0 + np.random.uniform(-self.contrast, self.contrast)
            ops.append(lambda im: PIL.ImageEnhance.Contrast(im).enhance(f_c))
        if self.saturation:
            f_s = 1.0 + np.random.uniform(-self.saturation, self.saturation)
            ops.append(lambda im: PIL.ImageEnhance.Color(im).enhance(f_s))
        np.random.shuffle(ops)
        for op in ops:
            image = op(image)

        if self.hue:
            hue_shift = np.random.uniform(-self.hue, self.hue)
            hsv = np.array(image.convert('HSV'), dtype=np.int16)
            hsv[:, :, 0] = (hsv[:, :, 0] + int(hue_shift * 255)) % 256
            image = PIL.Image.fromarray(
                hsv.astype(np.uint8), mode='HSV').convert('RGB')
        return image, anns, meta


class RandomGrayscale(Preprocess):
    def __init__(self, p=0.01):
        self.p = p

    def __call__(self, image, anns, meta):
        if np.random.rand() < self.p:
            image = image.convert('L').convert('RGB')
        return image, anns, meta
