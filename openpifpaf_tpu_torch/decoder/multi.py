"""Multi decoder: concatenates the annotations of several decoders per
image (port of ``openpifpaf_tpu/decoder/multi.py``; the decoders run one
after the other, the deferred API waits for the pipelined loop, ROADMAP
A5(b))."""

from .base import Decoder


class Multi(Decoder):
    def __init__(self, decoders):
        super().__init__()
        self.decoders = decoders

    def batch_decode(self, fields_batch):
        per_decoder = [d.batch_decode(fields_batch) for d in self.decoders]
        self.last_decoder_time = sum(d.last_decoder_time
                                     for d in self.decoders)
        if len(per_decoder) == 1:
            return per_decoder[0]
        return [
            [ann for decoder_out in image_outs for ann in decoder_out]
            for image_outs in zip(*per_decoder)
        ]

    def __call__(self, fields):
        return [ann for d in self.decoders for ann in d(fields)]
