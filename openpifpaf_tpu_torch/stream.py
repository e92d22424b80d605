"""Video stream source (copy of ``openpifpaf_tpu/stream.py``): OpenCV
capture of webcam/url/file/screen with scale/rotate/crop and start-frame
options.

Still-image sources (single files or comma-separated lists) are decoded
with PIL, so OpenCV stays optional."""

import logging
import os
import time

import numpy as np
import PIL.Image

try:
    import cv2
except ImportError:
    cv2 = None

LOG = logging.getLogger(__name__)

_IMAGE_EXTENSIONS = ('.jpg', '.jpeg', '.png', '.bmp', '.ppm', '.webp')


class Stream:
    def __init__(self, source, *, preprocess=None, scale=1.0, start_frame=None,
                 start_msec=None, crop=None, rotate=None, max_frames=None,
                 horizontal_flip=False, with_raw_image=True):
        self.image_sources = None
        if isinstance(source, str):
            parts = source.split(',')
            if all(p.lower().endswith(_IMAGE_EXTENSIONS) and os.path.exists(p)
                   for p in parts):
                self.image_sources = parts
        if cv2 is None and self.image_sources is None:
            raise ImportError('opencv is required for video streams')

        self.source = source
        self.preprocess = preprocess
        self.scale = scale
        self.start_frame = start_frame
        self.start_msec = start_msec
        self.crop = crop
        self.rotate = rotate
        self.horizontal_flip = horizontal_flip
        self.max_frames = max_frames
        self.with_raw_image = with_raw_image

        if isinstance(source, str) and source.isdigit():
            self.source = int(source)

    def _iter_images(self):
        for frame_i, path in enumerate(self.image_sources):
            if self.max_frames is not None and frame_i >= self.max_frames:
                break
            with open(path, 'rb') as f:
                pil_image = PIL.Image.open(f).convert('RGB')
            if self.horizontal_flip:
                pil_image = pil_image.transpose(
                    PIL.Image.Transpose.FLIP_LEFT_RIGHT)
            if self.scale != 1.0:
                pil_image = pil_image.resize(
                    (int(pil_image.size[0] * self.scale),
                     int(pil_image.size[1] * self.scale)))
            if self.rotate:
                pil_image = pil_image.rotate(self.rotate, expand=True)
            if self.crop:
                left, top, right, bottom = self.crop
                pil_image = pil_image.crop(
                    (left, top, pil_image.size[0] - right,
                     pil_image.size[1] - bottom))
            image = np.asarray(pil_image)

            meta = {
                'frame_i': frame_i + 1,
                'time': time.time(),
                'dataset_index': frame_i + 1,
                'file_name': path,
            }
            anns = []
            if self.preprocess is not None:
                processed, anns, meta = self.preprocess(pil_image, anns, meta)
            else:
                processed = image

            if self.with_raw_image:
                yield image, processed, anns, meta
            else:
                yield processed, anns, meta

    def __iter__(self):
        if self.image_sources is not None:
            yield from self._iter_images()
            return
        capture = cv2.VideoCapture(self.source)
        if self.start_frame:
            capture.set(cv2.CAP_PROP_POS_FRAMES, self.start_frame)
        if self.start_msec:
            capture.set(cv2.CAP_PROP_POS_MSEC, self.start_msec)

        frame_i = 0
        while True:
            if self.max_frames is not None and frame_i >= self.max_frames:
                break
            ret, image = capture.read()
            if not ret:
                break
            frame_i += 1

            image = cv2.cvtColor(image, cv2.COLOR_BGR2RGB)
            if self.scale != 1.0:
                image = cv2.resize(image, None,
                                   fx=self.scale, fy=self.scale)
            if self.horizontal_flip:
                image = image[:, ::-1]
            if self.rotate:
                if self.rotate == 90:
                    image = cv2.rotate(image, cv2.ROTATE_90_COUNTERCLOCKWISE)
                elif self.rotate == 180:
                    image = cv2.rotate(image, cv2.ROTATE_180)
                elif self.rotate == 270:
                    image = cv2.rotate(image, cv2.ROTATE_90_CLOCKWISE)
            if self.crop:
                left, top, right, bottom = self.crop
                image = image[top:image.shape[0] - bottom,
                              left:image.shape[1] - right]

            meta = {
                'frame_i': frame_i,
                'time': time.time(),
                'dataset_index': frame_i,
                'file_name': f'frame-{frame_i:06d}',
            }
            pil_image = PIL.Image.fromarray(image)
            anns = []
            if self.preprocess is not None:
                processed, anns, meta = self.preprocess(pil_image, anns, meta)
            else:
                processed = np.asarray(pil_image)

            if self.with_raw_image:
                yield image, processed, anns, meta
            else:
                yield processed, anns, meta

        capture.release()
