"""Predict CLI of the port (counterpart of ``openpifpaf_tpu/predict.py``).

Example:
    python -m openpifpaf_tpu_torch.predict image.jpg --json-output
"""

import argparse
import glob
import json
import logging
import os

from . import __version__, decoder

LOG = logging.getLogger(__name__)


def cli(args=None):
    parser = argparse.ArgumentParser(
        prog='python3 -m openpifpaf_tpu_torch.predict',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument('--version', action='version',
                        version=f'OpenPifPaf-TPU (PyTorch) {__version__}')
    parser.add_argument('images', nargs='*', help='input images')
    parser.add_argument('--glob', help='glob expression for input images')
    parser.add_argument('--checkpoint', default=None,
                        help='not yet ported: only random-init '
                             'shufflenetv2k16 runs')
    parser.add_argument('--long-edge', default=None, type=int,
                        help='rescale the long side of the image')
    parser.add_argument('--batch-size', default=1, type=int)
    parser.add_argument('--json-output', default=None, nargs='?',
                        const=True, help='json output file or directory')
    parser.add_argument('--debug', default=False, action='store_true')
    decoder.cli(parser)

    args = parser.parse_args(args)
    logging.basicConfig(level=logging.DEBUG if args.debug else logging.INFO)
    decoder.configure(args)
    if args.glob:
        args.images += glob.glob(args.glob)
    if not args.images:
        parser.error('no image files given')
    return args


def out_name(arg, in_name, default_extension):
    """Output name from the flag value, the input name and an extension."""
    if arg is None:
        return None
    if arg is True:
        return in_name + default_extension
    if os.path.isdir(arg):
        return os.path.join(arg, os.path.basename(in_name)) + default_extension
    return arg


def main(args=None):
    args = cli(args)
    from .predictor import Predictor

    predictor = Predictor(checkpoint=args.checkpoint)
    predictor.batch_size = args.batch_size
    predictor.long_edge = args.long_edge
    predictor.preprocess = predictor._build_preprocess()

    for pred, _, meta in predictor.images(args.images):
        json_out_name = out_name(
            args.json_output, meta['file_name'], '.predictions.json')
        if json_out_name is not None:
            LOG.debug('json output = %s', json_out_name)
            with open(json_out_name, 'w') as f:
                json.dump([ann.json_data() for ann in pred], f)
        LOG.info('%s: %d annotations', meta['file_name'], len(pred))


if __name__ == '__main__':
    main()
