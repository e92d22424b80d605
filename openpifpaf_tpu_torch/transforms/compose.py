"""Sequential transform composition (semantics of reference
``transforms/compose.py:6-18``); ``None`` entries are identity."""

from .preprocess import Preprocess


class Compose(Preprocess):
    def __init__(self, preprocess_list):
        self.preprocess_list = preprocess_list

    def __call__(self, *args):
        for step in self.preprocess_list:
            if step is not None:
                args = step(*args)
        return args
