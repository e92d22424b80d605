"""Preprocess ABC (reference ``transforms/preprocess.py:4-8``)."""


class Preprocess:
    def __call__(self, image, anns, meta):
        raise NotImplementedError
