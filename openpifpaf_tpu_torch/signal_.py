"""Minimal in-process pub/sub (copy of ``openpifpaf_tpu/signal_.py``).

Used for ``eval_reset`` events: video decoders and feature caches subscribe,
and the loader emits when the video sequence changes.
"""


class Signal:
    subscribers = {}

    @classmethod
    def subscribe(cls, signal_name, subscriber):
        cls.subscribers.setdefault(signal_name, []).append(subscriber)

    @classmethod
    def emit(cls, signal_name, *args, **kwargs):
        for subscriber in cls.subscribers.get(signal_name, []):
            subscriber(*args, **kwargs)
