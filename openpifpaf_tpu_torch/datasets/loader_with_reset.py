"""LoaderWithReset (copy of ``openpifpaf_tpu/datasets/loader_with_reset.py``):
emits the ``eval_reset`` Signal when a monitored meta key (e.g. the video
sequence's annotation file) changes, so feature caches and trackers reset
between sequences.

The signal fires when the consumer pulls the first batch of the next
sequence, so a consumer that finishes each batch before it pulls the
next (the Predictor's strict loop) resets after the previous sequence's
last frame and before the new sequence's first.
"""

from ..signal_ import Signal


class LoaderWithReset:
    def __init__(self, loader, monitored_key):
        self.loader = loader
        self.monitored_key = monitored_key

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        previous_value = None
        for images, anns, metas in self.loader:
            current_value = metas[0].get(self.monitored_key)
            if previous_value is not None and current_value != previous_value:
                Signal.emit('eval_reset')
            previous_value = current_value
            yield images, anns, metas
