"""Conflict resolution for vectorized target painting.

The encoders in this package generate *all* candidate cell writes up front
as flat arrays (cell key, write metric, sequential order, channel payload)
and resolve conflicts in one pass, instead of stamping patches into mutable
grids one keypoint at a time (the reference's approach,
``encoder/cif.py:101-130``). The sequential nearest-writer semantics map
exactly onto a sort:

* strict-``<`` stamping (CIF, CifDet): a later write only lands if its
  metric is strictly below the running minimum, so the surviving value per
  cell comes from the *earliest* writer attaining the global minimum;
* ``<=`` stamping (CAF, ``encoder/caf.py:189-191``): equal metrics
  overwrite, so the survivor is the *latest* writer attaining the minimum.

Both reduce to a lexicographic sort over (cell, metric, tiebreak) followed
by a first-per-cell selection; the per-cell initial barrier (1.0 inside
crowd regions, +inf elsewhere) filters candidates before the sort.
"""

import numpy as np


def resolve(keys, metric, order, barrier, *, ties):
    """Indices of the winning candidate per cell.

    keys: (M,) int flat cell ids. metric: (M,) priority, lower wins.
    order: (M,) sequential write index. barrier: (M,) the cell's initial
    metric value (candidates above it never land). ties: ``'first'`` for
    strict-< semantics, ``'last'`` for <= semantics.
    """
    keys = np.asarray(keys)
    metric = np.asarray(metric)
    order = np.asarray(order)
    if ties == 'first':
        alive = metric < barrier
        rank = order
    elif ties == 'last':
        alive = metric <= barrier
        rank = (order.max() - order) if order.size else order
    else:
        raise ValueError(ties)

    idx = np.flatnonzero(alive)
    if idx.size == 0:
        return idx
    sub = np.lexsort((rank[idx], metric[idx], keys[idx]))
    idx = idx[sub]
    lead = np.empty(idx.size, dtype=bool)
    lead[0] = True
    np.not_equal(keys[idx[1:]], keys[idx[:-1]], out=lead[1:])
    return idx[lead]


class PaddedPlanes:
    """Channel planes over a padded (F, H+2p, W+2p) grid, flat-indexed.

    Collects channel scatters, then crops padding and applies the
    valid-area mask on readout.
    """

    def __init__(self, n_fields, height, width, padding):
        self.n_fields = n_fields
        self.hp = height + 2 * padding
        self.wp = width + 2 * padding
        self.padding = padding

    def flat_keys(self, field_i, ys, xs):
        """Flat index for padded-grid coordinates (broadcast together)."""
        return (field_i * self.hp + ys) * self.wp + xs

    def plane(self, init):
        return np.full(self.n_fields * self.hp * self.wp, init,
                       dtype=np.float32)

    def paint_region(self, flat, region_mask, value):
        """Set ``value`` inside the unpadded region where ``region_mask``
        (either (H, W), broadcast over fields, or (F, H, W))."""
        p = self.padding
        grid = flat.reshape(self.n_fields, self.hp, self.wp)
        core = grid[:, p:-p, p:-p]
        core[np.broadcast_to(region_mask, core.shape)] = value

    def barrier_lookup(self, region_mask, inside_value):
        """Per-cell initial metric: ``inside_value`` where region_mask,
        +inf elsewhere; returned as a flat lookup table."""
        flat = self.plane(np.inf)
        self.paint_region(flat, region_mask, inside_value)
        return flat

    def cropped(self, flat, valid_area, fill_value):
        from ..utils import mask_valid_area
        p = self.padding
        grid = flat.reshape(self.n_fields, self.hp, self.wp)
        core = grid[:, p:-p, p:-p]
        mask_valid_area(core, valid_area, fill_value=fill_value)
        return core
