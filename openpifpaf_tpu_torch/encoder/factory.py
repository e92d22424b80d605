"""Encoder CLI wiring (flag surface of reference ``encoder/factory.py``).

Table-driven: each entry binds one CLI flag to one class attribute, so
``cli`` and ``configure`` cannot drift apart.
"""

from .annrescaler import AnnRescaler
from .caf import Caf
from .cif import Cif

# (flag, dest, target class, attribute, kwargs for add_argument)
_OPTIONS = [
    ('--cif-side-length', 'cif_side_length', Cif, 'side_length',
     dict(type=int, help='side length of the CIF field')),
    ('--caf-min-size', 'caf_min_size', Caf, 'min_size',
     dict(type=int, help='min side length of the CAF field')),
    ('--caf-fixed-size', 'caf_fixed_size', Caf, 'fixed_size',
     dict(action='store_true', help='fixed caf size')),
    ('--caf-aspect-ratio', 'caf_aspect_ratio', Caf, 'aspect_ratio',
     dict(type=float, help='CAF width relative to its length')),
    ('--encoder-no-suppress-selfhidden', 'encoder_suppress_selfhidden',
     AnnRescaler, 'suppress_selfhidden', dict(action='store_false')),
    ('--encoder-suppress-invisible', 'encoder_suppress_invisible',
     AnnRescaler, 'suppress_invisible', dict(action='store_true')),
    ('--encoder-suppress-collision', 'encoder_suppress_collision',
     AnnRescaler, 'suppress_collision', dict(action='store_true')),
]


def cli(parser):
    group = parser.add_argument_group('encoders')
    for flag, dest, cls, attr, kwargs in _OPTIONS:
        group.add_argument(flag, dest=dest, default=getattr(cls, attr),
                           **kwargs)


def configure(args):
    for _, dest, cls, attr, _kwargs in _OPTIONS:
        setattr(cls, attr, getattr(args, dest))
