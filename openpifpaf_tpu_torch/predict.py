"""Predict CLI of the port (counterpart of ``openpifpaf_tpu/predict.py``).

Example:
    python -m openpifpaf_tpu_torch.predict image.jpg --json-output
    python -m openpifpaf_tpu_torch.predict image.jpg -o out/ \
        --show-decoding-order

``-o/--image-output`` and ``--show`` draw the annotations with ``show/``
(matplotlib); ``--debug-indices`` draws the decoder's fields with
``visualizer/``.
"""

import argparse
import glob
import json
import logging
import os

from . import __version__, decoder, logger
from .predictor import BACKBONE_ENGINES, Predictor

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
                        help='checkpoint of the port (path without '
                             '.json/.pt), a reference .pkl or a published '
                             'name (e.g. shufflenetv2k16); default: '
                             'random-init shufflenetv2k16')
    parser.add_argument('--long-edge', default=None, type=int,
                        help='rescale the long side of the image')
    parser.add_argument('--batch-size', default=1, type=int)
    parser.add_argument('--device', default='cuda',
                        help='torch device of the forward and the decode; '
                             '"cpu" runs on the CPU (the counterpart of '
                             'JAX_PLATFORMS=cpu)')
    parser.add_argument('--bf16', default=False, action='store_true',
                        help='run the backbone in bfloat16; heads and '
                             'decode stay float32')
    parser.add_argument('--backbone-engine', default='auto',
                        choices=BACKBONE_ENGINES,
                        help='serving backbone engine: flax = the module '
                             'graph; folded (= halves = stencil) = '
                             'BatchNorm folded into the convs; dwpallas = '
                             'folded with the depthwise CUDA kernel; '
                             'pallas = folded with the fused-block CUDA '
                             'kernel; auto = halves when every stage\'s '
                             'channel halves are 128-multiples, flax '
                             'otherwise')
    parser.add_argument('--hflip-tta', default=False, action='store_true',
                        help='average fields with the mirrored-image '
                             'forward pass (test-time augmentation)')
    parser.add_argument('--multi-scale', default=False, action='store_true',
                        help='decode at multiple scales and merge with '
                             'OKS suppression (test-time augmentation)')
    parser.add_argument('--no-pipeline-decode',
                        dest='pipeline_decode', default=True,
                        action='store_false',
                        help='serve batch at a time: without it, batch '
                             'i+1\'s forward is queued before batch i\'s '
                             'decode runs (on a side CUDA stream)')
    parser.add_argument('--n-devices', default=None, type=int,
                        help='split the forward batch over the first N '
                             'CUDA devices, one replica each; the fields '
                             'are decoded on the first')
    parser.add_argument('--spatial-devices', default=None, type=int,
                        help='with --n-devices: split each image\'s height '
                             'over this many of the devices (halo '
                             'exchanges); the fields are decoded whole on '
                             'the first')
    parser.add_argument('-o', '--image-output', default=None, nargs='?',
                        const=True, help='image output file or directory')
    parser.add_argument('--json-output', default=None, nargs='?',
                        const=True, help='json output file or directory')
    parser.add_argument('--precise-rescaling', dest='fast_rescaling',
                        default=True, action='store_false',
                        help='accepted and ignored: a no-op, as in the '
                             'JAX package, whose rescale never reads it')
    parser.add_argument('--debug', default=False, action='store_true')
    logger.cli(parser)
    decoder.cli(parser)
    from . import show, visualizer
    visualizer.cli(parser)
    show.cli(parser)

    args = parser.parse_args(args)
    logger.configure(args, LOG)
    decoder.configure(args)
    visualizer.configure(args)
    show.configure(args)
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
    predictor = Predictor(checkpoint=args.checkpoint, device=args.device,
                          backbone_engine=args.backbone_engine,
                          bf16=args.bf16, n_devices=args.n_devices,
                          spatial_devices=args.spatial_devices)
    predictor.batch_size = args.batch_size
    predictor.pipeline_decode = args.pipeline_decode
    predictor.hflip_tta = args.hflip_tta
    predictor.multi_scale = args.multi_scale
    predictor.long_edge = args.long_edge
    predictor.preprocess = predictor._build_preprocess()

    annotation_painter = None
    if args.image_output is not None or args.show:
        from . import show
        annotation_painter = show.AnnotationPainter()

    for pred, _, meta in predictor.images(args.images):
        json_out_name = out_name(
            args.json_output, meta['file_name'], '.predictions.json')
        if json_out_name is not None:
            LOG.debug('json output = %s', json_out_name)
            with open(json_out_name, 'w') as f:
                json.dump([ann.json_data() for ann in pred], f)

        if annotation_painter is not None:
            import PIL.Image
            image_out_name = out_name(
                args.image_output, meta['file_name'], '.predictions.jpg')
            with open(meta['file_name'], 'rb') as f:
                image = PIL.Image.open(f).convert('RGB')
            with show.image_canvas(image, image_out_name,
                                   show=args.show) as ax:
                annotation_painter.annotations(ax, pred)

        LOG.info('%s: %d annotations', meta['file_name'], len(pred))


if __name__ == '__main__':
    main()
