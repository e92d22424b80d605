"""Metric base class (reference ``metric/base.py``)."""


class Base:
    def accumulate(self, predictions, image_meta, *, ground_truth=None):
        raise NotImplementedError

    def stats(self):
        raise NotImplementedError

    def write_predictions(self, filename, *, additional_data=None):
        raise NotImplementedError
