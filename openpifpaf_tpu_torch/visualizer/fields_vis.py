"""Field visualizers: Cif, Caf, CifHr, CifDet, Seeds, Occupancy,
MultiTracking and Tcaf (copy of ``openpifpaf_tpu/visualizer/fields_vis.py``).
Each draws numpy arrays."""

import copy
import logging

import numpy as np

from .base import Base
from .. import headmeta

try:
    import matplotlib
    CMAP_ORANGES_NAN = copy.copy(matplotlib.colormaps['Oranges'])
    CMAP_ORANGES_NAN.set_bad('white', alpha=0.5)
except ImportError:
    matplotlib = None
    CMAP_ORANGES_NAN = None

LOG = logging.getLogger(__name__)


class Cif(Base):
    def __init__(self, meta: headmeta.Cif):
        super().__init__(meta.name)
        self.meta = meta

    def targets(self, field, *, annotation_dicts=None):
        field = np.asarray(field)
        self._confidences(field[:, 0])
        self._regressions(field[:, 1:3], field[:, 4], uv_is_offset=True)

    def predicted(self, field):
        field = np.asarray(field)
        self._confidences(field[:, 1])
        self._regressions(field[:, 2:4], field[:, 4],
                          confidence_fields=field[:, 1], uv_is_offset=False)

    def _confidences(self, confidences):
        for f in self.indices('confidence'):
            with self.image_canvas(self._processed_image) as ax:
                im = ax.imshow(
                    self.scale_scalar(confidences[f], self.meta.stride),
                    alpha=0.9, vmin=0.0, vmax=1.0, cmap=CMAP_ORANGES_NAN)
                self.colorbar(ax, im)

    def _regressions(self, regression_fields, scale_fields, *,
                     confidence_fields=None, uv_is_offset=True):
        from ..show import fields as show_fields

        for f in self.indices('regression'):
            with self.image_canvas(self._processed_image) as ax:
                show_fields.white_screen(ax, alpha=0.5)
                conf = (confidence_fields[f]
                        if confidence_fields is not None else None)
                show_fields.quiver(
                    ax, regression_fields[f],
                    confidence_field=conf,
                    xy_scale=self.meta.stride,
                    uv_is_offset=uv_is_offset)


class Caf(Base):
    def __init__(self, meta: headmeta.Caf):
        super().__init__(meta.name)
        self.meta = meta

    def targets(self, field, *, annotation_dicts=None):
        field = np.asarray(field)
        self._confidences(field[:, 0])
        self._regressions(field[:, 1:3], field[:, 3:5], uv_is_offset=True)

    def predicted(self, field):
        field = np.asarray(field)
        self._confidences(field[:, 1])
        self._regressions(field[:, 2:4], field[:, 4:6],
                          confidence_fields=field[:, 1], uv_is_offset=False)

    def _confidences(self, confidences):
        for f in self.indices('confidence'):
            with self.image_canvas(self._processed_image) as ax:
                im = ax.imshow(
                    self.scale_scalar(confidences[f], self.meta.stride),
                    alpha=0.9, vmin=0.0, vmax=1.0, cmap=CMAP_ORANGES_NAN)
                self.colorbar(ax, im)

    def _regressions(self, regression1, regression2, *,
                     confidence_fields=None, uv_is_offset=True):
        from ..show import fields as show_fields

        for f in self.indices('regression'):
            with self.image_canvas(self._processed_image) as ax:
                show_fields.white_screen(ax, alpha=0.5)
                conf = (confidence_fields[f]
                        if confidence_fields is not None else None)
                for reg in (regression1, regression2):
                    show_fields.quiver(
                        ax, reg[f], confidence_field=conf,
                        xy_scale=self.meta.stride,
                        uv_is_offset=uv_is_offset)


class CifHr(Base):
    def __init__(self, *, stride=1, field_names=None):
        super().__init__('cifhr')
        self.stride = stride
        self.field_names = field_names

    def predicted(self, fields, low=0.0):
        fields = np.asarray(fields)
        for f in self.indices():
            with self.image_canvas(self._processed_image) as ax:
                im = ax.imshow(fields[f], alpha=0.9,
                               vmin=low, vmax=low + 1.0,
                               cmap=CMAP_ORANGES_NAN)
                self.colorbar(ax, im)


class CifDet(Base):
    def __init__(self, meta: headmeta.CifDet):
        super().__init__(meta.name)
        self.meta = meta

    def targets(self, field, *, annotation_dicts=None):
        field = np.asarray(field)
        self._confidences(field[:, 0])

    def predicted(self, field):
        field = np.asarray(field)
        self._confidences(field[:, 1])

    def _confidences(self, confidences):
        for f in self.indices('confidence'):
            with self.image_canvas(self._processed_image) as ax:
                im = ax.imshow(
                    self.scale_scalar(confidences[f], self.meta.stride),
                    alpha=0.9, vmin=0.0, vmax=1.0, cmap=CMAP_ORANGES_NAN)
                self.colorbar(ax, im)


class Seeds(Base):
    def __init__(self, *, stride=1):
        super().__init__('seeds')
        self.stride = stride

    def predicted(self, seeds):
        """seeds: iterable of (f, v, x, y, ...)."""
        if not self.indices():
            return
        with self.image_canvas(self._processed_image) as ax:
            for seed in seeds:
                f, v, x, y = seed[0], seed[1], seed[2], seed[3]
                ax.plot([x], [y], 'o', markersize=4)
                ax.text(x, y, f'{f}:{v:.2f}', fontsize=6)


class Occupancy(Base):
    def __init__(self, *, field_names=None):
        super().__init__('occupancy')
        self.field_names = field_names

    def predicted(self, occupancy):
        occupancy = np.asarray(occupancy)
        for f in self.indices():
            with self.image_canvas(self._processed_image) as ax:
                im = ax.imshow(occupancy[f], alpha=0.7, cmap='Greys')
                self.colorbar(ax, im)


class MultiTracking(Base):
    def __init__(self, meta):
        super().__init__(meta.name)
        self.meta = meta

    def predicted(self, annotations):
        if not self.indices():
            return
        from ..show.painters import AnnotationPainter
        with self.image_canvas(self._processed_image) as ax:
            AnnotationPainter().annotations(ax, annotations)


class Tcaf(Caf):
    """Temporal-association field overlay (reference ``visualizer/tcaf.py``):
    identical field composition to Caf, drawn on the primary frame."""
