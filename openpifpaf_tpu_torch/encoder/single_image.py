"""Adapter running a single-image encoder on one frame of a pair group
(copy of ``openpifpaf_tpu/encoder/single_image.py``)."""


class SingleImage:
    frame = 0

    def __init__(self, wrapped):
        self.wrapped = wrapped

    meta = property(lambda self: self.wrapped.meta)

    def __call__(self, images, anns, metas):
        i = self.frame
        return self.wrapped(images[i], anns[i], metas[i])
