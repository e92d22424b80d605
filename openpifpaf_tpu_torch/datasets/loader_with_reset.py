"""LoaderWithReset (copy of ``openpifpaf_tpu/datasets/loader_with_reset.py``):
emits the ``eval_reset`` Signal when a monitored meta key (e.g. the video
sequence's annotation file) changes, so feature caches and trackers reset
between sequences.

The signal fires when the consumer pulls the first batch of the next
sequence, so a consumer that finishes each batch before it pulls the
next resets after the previous sequence's last frame and before the new
sequence's first. A consumer that pulls ahead (the Predictor's prefetch
thread) takes :meth:`LoaderWithReset.marked` instead, whose ``RESET``
markers travel with the batches and are turned into the signal where the
batches are used.
"""

from ..signal_ import Signal


class LoaderWithReset:
    #: the marker between two sequences in :meth:`marked`
    RESET = object()

    def __init__(self, loader, monitored_key):
        self.loader = loader
        self.monitored_key = monitored_key

    def __len__(self):
        return len(self.loader)

    def marked(self):
        """The loader's batches with ``RESET`` before the first batch of
        each sequence but the first."""
        previous_value = None
        for images, anns, metas in self.loader:
            current_value = metas[0].get(self.monitored_key)
            if previous_value is not None and current_value != previous_value:
                yield self.RESET
            previous_value = current_value
            yield images, anns, metas

    def __iter__(self):
        for item in self.marked():
            if item is self.RESET:
                Signal.emit('eval_reset')
                continue
            yield item
