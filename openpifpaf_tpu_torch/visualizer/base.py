"""Visualizer base (copy of ``openpifpaf_tpu/visualizer/base.py``).

Visualizers draw debug overlays for intermediate fields. Fields to plot are
requested via ``--debug-indices headname:fieldindex[:type]``; the request
state is shared through class attributes like the reference's global stash.
"""

import logging
from contextlib import contextmanager

import numpy as np

LOG = logging.getLogger(__name__)


class Base:
    all_indices = []
    common_ax = None
    processed_image_intensity_spread = 2.0

    _image = None
    _processed_image = None
    _image_meta = None
    _ground_truth = None

    def __init__(self, head_name):
        self.head_name = head_name
        self._ax = None

    @staticmethod
    def set_all_indices(all_indices):
        """Parse --debug-indices entries 'head:field[:type]' with comma
        lists, e.g. 'cif:5,6:confidence,hr'."""
        parsed = []
        for entry in all_indices:
            parts = entry.split(':')
            head_names = parts[0].split(',')
            field_indices = [int(i) for i in parts[1].split(',')] \
                if len(parts) > 1 else []
            types = parts[2].split(',') if len(parts) > 2 else ['all']
            for hn in head_names:
                for fi in field_indices:
                    for t in types:
                        parsed.append((hn, fi, t))
        Base.all_indices = parsed

    @classmethod
    def image(cls, image=None, meta=None):
        if image is None:
            cls._image = None
            cls._image_meta = None
            return cls
        cls._image = np.asarray(image)
        cls._image_meta = meta
        return cls

    @classmethod
    def processed_image(cls, image=None):
        if image is None:
            return cls._processed_image
        image = np.asarray(image)
        image = 0.5 + 0.5 * image / cls.processed_image_intensity_spread
        cls._processed_image = np.clip(image, 0.0, 1.0)
        return cls

    @classmethod
    def ground_truth(cls, ground_truth):
        cls._ground_truth = ground_truth
        return cls

    @classmethod
    def reset(cls):
        cls._image = None
        cls._image_meta = None
        cls._processed_image = None
        cls._ground_truth = None

    def indices(self, type_=None):
        """Field indices requested for this head (and visualization type)."""
        return [
            fi for hn, fi, t in self.all_indices
            if hn == self.head_name and (type_ is None or t in ('all', type_))
        ]

    @contextmanager
    def image_canvas(self, image=None, **kwargs):
        from ..show.canvas import image_canvas as show_image_canvas, canvas

        if self.common_ax is not None:
            yield self.common_ax
            return
        if image is not None:
            with show_image_canvas(image, show=True, **kwargs) as ax:
                yield ax
            return
        with canvas(show=True, **kwargs) as ax:
            yield ax

    @staticmethod
    def scale_scalar(field, stride):
        field = np.repeat(field, stride, 0)
        field = np.repeat(field, stride, 1)
        # center the feature cells
        half = stride // 2
        return field[max(0, half - 1):, max(0, half - 1):]

    @staticmethod
    def colorbar(ax, im):
        import matplotlib.pyplot as plt
        plt.colorbar(im, ax=ax, fraction=0.046, pad=0.04)

    def targets(self, field, *, annotation_dicts=None):
        """Visualize encoded targets."""

    def predicted(self, field):
        """Visualize predicted fields."""
