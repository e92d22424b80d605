"""Compatibility alias (copy of ``openpifpaf_tpu/transforms/minsize.py``): MinSize lives with the other crowd-demotion
filters in :mod:`.unclipped`."""

from .unclipped import MinSize

__all__ = ['MinSize']
