"""Visualizer flag wiring (copy of ``openpifpaf_tpu/visualizer/cli.py``)."""

from .base import Base

_INDICES_HELP = (
    'which fields to render debug plots for, as headname:fieldindex '
    '(e.g. cif:5) with an optional visualization type suffix '
    '(e.g. cif:5:confidence)')


def cli(parser):
    parser.add_argument_group('visualizer').add_argument(
        '--debug-indices', default=[], nargs='+', help=_INDICES_HELP)


def configure(args):
    Base.set_all_indices(args.debug_indices)
