"""Decoder base class (copy of ``openpifpaf_tpu/decoder/base.py``)."""

import time


class Decoder:
    def __init__(self):
        self.last_decoder_time = 0.0
        self.last_nn_time = 0.0

    def __call__(self, fields):
        """Decode a single image's fields into annotations."""
        raise NotImplementedError

    def batch_decode(self, fields_batch):
        """Decode a batch image by image.

        fields_batch: per-head list of (B, ...) tensors (the Predictor's
        contract); each image gets the per-head slices.
        """
        start = time.perf_counter()
        n_images = len(fields_batch[0])
        result = [self([f[i] for f in fields_batch])
                  for i in range(n_images)]
        self.last_decoder_time = time.perf_counter() - start
        return result
