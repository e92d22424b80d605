"""Multi decoder: concatenates the annotations of several decoders per
image (port of ``openpifpaf_tpu/decoder/multi.py``)."""

from .base import Decoder


class Multi(Decoder):
    def __init__(self, decoders):
        super().__init__()
        self.decoders = decoders

    def batch_decode(self, fields_batch):
        return self.batch_decode_deferred(fields_batch)()

    def batch_decode_deferred(self, fields_batch):
        """Dispatch every sub-decoder; return ``materialize()`` (see
        ``CifCaf.batch_decode_deferred``). A sub-decoder without a
        deferred API, or with an instance-level ``batch_decode`` override
        (the ``--profile-decoder`` wrapper of the factory), runs its
        ``batch_decode`` at dispatch, so that the override is never
        bypassed. Each sub-decoder's time is read where its decode
        ended: at dispatch for those, at materialize for the deferred
        ones, so that a batch dispatched in between does not count."""
        staged = []
        for d in self.decoders:
            if hasattr(d, 'batch_decode_deferred') \
                    and 'batch_decode' not in d.__dict__:
                staged.append((d, d.batch_decode_deferred(fields_batch),
                               None))
            else:
                staged.append((d, None, (d.batch_decode(fields_batch),
                                         d.last_decoder_time)))

        def materialize():
            per_decoder = []
            decoder_time = 0.0
            for d, deferred, done in staged:
                if deferred is not None:
                    done = (deferred(), d.last_decoder_time)
                per_decoder.append(done[0])
                decoder_time += done[1]
            self.last_decoder_time = decoder_time
            if len(per_decoder) == 1:
                return per_decoder[0]
            return [
                [ann for decoder_out in image_outs for ann in decoder_out]
                for image_outs in zip(*per_decoder)
            ]

        return materialize

    def __call__(self, fields):
        return [ann for d in self.decoders for ann in d(fields)]
