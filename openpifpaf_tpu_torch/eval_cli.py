"""Eval CLI of the port (counterpart of ``openpifpaf_tpu/eval_cli.py``).

Runs on the first CUDA device unless ``--device cpu`` is given; without a
card the default raises.

Example:
    python -m openpifpaf_tpu_torch.eval --dataset cocokp --checkpoint model
"""

import argparse
import glob
import json
import logging
import os
import time

import torch

from . import __version__, datasets, decoder, logger
from .predictor import BACKBONE_ENGINES, Predictor

LOG = logging.getLogger(__name__)


class Evaluator:
    skip_epoch0 = True
    skip_existing = True
    show_final_image = False
    show_final_ground_truth = False
    n_images = None
    loader_warmup = 3.0
    bf16 = False
    backbone_engine = 'auto'
    hflip_tta = False
    device = 'cuda'
    #: eval reports the nn/decoder split, which the strict loop keeps
    #: exact; ``--pipeline-decode`` opts into the pipelined loop
    pipeline_decode = False

    def __init__(self, dataset_name: str):
        self.dataset_name = dataset_name
        self.datamodule = datasets.factory(dataset_name)
        self.data_loader = self.datamodule.eval_loader()

    def accumulate(self, predictor, metrics):
        prediction_loader = predictor.dataloader(self.data_loader)
        if self.loader_warmup:
            LOG.info('Data loader warmup (%.1fs) ...', self.loader_warmup)
            time.sleep(self.loader_warmup)
        total_start = time.perf_counter()
        loop_start = time.perf_counter()

        last = None
        for image_i, (pred, gt_anns, image_meta) in enumerate(
                prediction_loader):
            LOG.info('image %d / %d, last loop: %.3fs, images per second=%.1f',
                     image_i, len(self.data_loader),
                     time.perf_counter() - loop_start,
                     image_i / max(1e-6, time.perf_counter() - total_start))
            loop_start = time.perf_counter()
            for metric in metrics:
                metric.accumulate(pred, image_meta, ground_truth=gt_anns)
            last = (pred, gt_anns, image_meta)
            if self.n_images is not None and image_i >= self.n_images - 1:
                break

        total_time = time.perf_counter() - total_start
        if self.show_final_image and last is not None:
            self._show_final(*last)
        return total_time

    def _show_final(self, pred, gt_anns, image_meta):
        """--eval-show-final-image [--eval-show-final-ground-truth]: the
        last image with its predictions (and its ground truth in grey) as
        ``{dataset}-eval-final-image.png``."""
        import PIL.Image
        from . import show

        with PIL.Image.open(image_meta['local_file_path']) as f:
            image = f.convert('RGB')
        annotation_painter = show.AnnotationPainter()
        out_name = f'{self.dataset_name}-eval-final-image.png'
        with show.image_canvas(image, fig_file=out_name, show=False) as ax:
            annotation_painter.annotations(ax, pred)
            if self.show_final_ground_truth:
                annotation_painter.annotations(
                    ax, gt_anns, color='grey')
        LOG.info('final image written: %s', out_name)

    def evaluate(self, output: str, *, checkpoint=None, model=None,
                 write_predictions=False):
        predictor = Predictor(
            checkpoint=checkpoint, model=model,
            head_metas=self.datamodule.head_metas, device=self.device,
            backbone_engine=self.backbone_engine, bf16=self.bf16)
        predictor.hflip_tta = self.hflip_tta
        predictor.pipeline_decode = self.pipeline_decode
        metrics = self.datamodule.metrics()

        total_time = self.accumulate(predictor, metrics)

        # model stats: JAX's eval writes no operation count either
        # (openpifpaf_tpu/eval_cli.py); count_ops.py counts them
        counted_ops = None
        file_size = -1
        if checkpoint and os.path.exists(checkpoint + '.pt'):
            file_size = os.path.getsize(checkpoint + '.pt')

        # write
        for metric_i, metric in enumerate(metrics):
            this_output = output if len(metrics) == 1 \
                else f'{output}.{metric_i}'
            if write_predictions:
                metric.write_predictions(this_output)

            stats = metric.stats()
            additional = {
                'total_time': total_time,
                'checkpoint': checkpoint,
                'dataset': self.dataset_name,
                'count_ops': counted_ops,
                'file_size': file_size,
                'n_images': predictor.total_images,
                'decoder_time': predictor.total_decoder_time,
                'nn_time': predictor.total_nn_time,
            }
            stats.update(additional)
            with open(this_output + '.stats.json', 'w') as f:
                json.dump(stats, f)
            LOG.info('stats:\n%s', json.dumps(stats, indent=4))
            LOG.info(
                'time per image: total %.3fs, nn %.3fs, dec %.3fs',
                total_time / max(1, predictor.total_images),
                predictor.total_nn_time / max(1, predictor.total_images),
                predictor.total_decoder_time / max(1, predictor.total_images))


def cli(argv=None):
    parser = argparse.ArgumentParser(
        prog='python3 -m openpifpaf_tpu_torch.eval_cli',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument('--version', action='version',
                        version=f'OpenPifPaf-TPU (PyTorch) {__version__}')
    parser.add_argument('--output', default=None)
    parser.add_argument('--dataset', default='cocokp')
    parser.add_argument('--checkpoint', default=None,
                        help='checkpoint of the port (path without '
                             '.json/.pt), a reference .pkl or a published '
                             'name (e.g. shufflenetv2k16); default: '
                             'random-init shufflenetv2k16')
    parser.add_argument('--batch-size', default=1, type=int)
    parser.add_argument('--loader-workers', default=0, type=int)
    parser.add_argument('--device', default='cuda',
                        help='torch device of the forward and the decode; '
                             '"cpu" runs on the CPU (the counterpart of '
                             'JAX_PLATFORMS=cpu)')
    parser.add_argument('--n-images', '--eval-n-images', dest='n_images',
                        default=None, type=int)
    parser.add_argument('--eval-loader-warmup',
                        default=Evaluator.loader_warmup, type=float)
    parser.add_argument('--eval-show-final-image', default=False,
                        action='store_true',
                        help='show the final image with predictions')
    parser.add_argument('--eval-show-final-ground-truth', default=False,
                        action='store_true',
                        help='show the final image with ground truth '
                             'annotations')
    parser.add_argument('--eval-no-skip-epoch0', dest='eval_skip_epoch0',
                        default=True, action='store_false',
                        help='do not skip epoch 0 in --watch')
    parser.add_argument('--eval-no-skip-existing', dest='eval_skip_existing',
                        default=True, action='store_false',
                        help='re-evaluate existing stats files in --watch')
    parser.add_argument('--bf16', default=False, action='store_true',
                        help='run the backbone in bfloat16')
    parser.add_argument('--backbone-engine', default='auto',
                        choices=BACKBONE_ENGINES,
                        help='serving backbone engine (see predict)')
    parser.add_argument('--pipeline-decode', default=False,
                        action='store_true',
                        help='the pipelined serving loop (batch i+1\'s '
                             'forward queued before batch i\'s decode); '
                             'its nn/decoder time split is approximate')
    parser.add_argument('--hflip-tta', default=False, action='store_true',
                        help='average fields with the mirrored-image '
                             'forward pass (test-time augmentation)')
    parser.add_argument('--write-predictions', '--eval-write-predictions',
                        dest='write_predictions', default=False,
                        action='store_true')
    parser.add_argument('--watch', default=False, nargs='?', const=60,
                        type=int,
                        help='poll for new checkpoints with this interval')
    parser.add_argument('--debug', default=False, action='store_true')
    logger.cli(parser)
    decoder.cli(parser)
    for dm in datasets.datamodules().values():
        dm.cli(parser)

    args = parser.parse_args(argv)
    logger.configure(args, LOG)
    decoder.configure(args)
    for dm in datasets.datamodules().values():
        dm.configure(args)
    return args


def _evaluator(args):
    evaluator = Evaluator(args.dataset)
    evaluator.n_images = args.n_images
    evaluator.bf16 = args.bf16
    evaluator.backbone_engine = args.backbone_engine
    evaluator.hflip_tta = args.hflip_tta
    evaluator.device = args.device
    evaluator.pipeline_decode = args.pipeline_decode
    return evaluator


def main(argv=None):
    args = cli(argv)
    if args.device.startswith('cuda') and not torch.cuda.is_available():
        raise RuntimeError('eval: no CUDA device found; pass --device cpu '
                           'to evaluate on the CPU')

    for dm in datasets.datamodules().values():
        dm.batch_size = args.batch_size
        dm.loader_workers = args.loader_workers

    Evaluator.loader_warmup = args.eval_loader_warmup
    Evaluator.show_final_image = args.eval_show_final_image
    Evaluator.show_final_ground_truth = args.eval_show_final_ground_truth
    Evaluator.skip_epoch0 = args.eval_skip_epoch0
    Evaluator.skip_existing = args.eval_skip_existing

    if args.output is None:
        args.output = (args.checkpoint or 'eval') + '.eval-' + args.dataset

    if args.watch:
        # reference eval.py:216-240: poll the checkpoint pattern and
        # evaluate each new checkpoint as it appears
        evaluated = set()
        while True:
            for meta_file in sorted(glob.glob(args.checkpoint
                                              + '.epoch*.json')):
                checkpoint = meta_file[:-len('.json')]
                if checkpoint in evaluated:
                    continue
                if not os.path.exists(checkpoint + '.pt'):
                    continue
                if (Evaluator.skip_epoch0
                        and checkpoint.endswith('.epoch000')):
                    continue
                # multi-metric datamodules write '<output>.<i>.stats.json'
                # instead of '<output>.stats.json'; glob covers both so
                # already-evaluated checkpoints survive a watch restart
                if (Evaluator.skip_existing and glob.glob(
                        checkpoint + '.eval-' + args.dataset
                        + '*.stats.json')):
                    evaluated.add(checkpoint)
                    continue
                LOG.info('watch: evaluating %s', checkpoint)
                _evaluator(args).evaluate(
                    checkpoint + '.eval-' + args.dataset,
                    checkpoint=checkpoint,
                    write_predictions=args.write_predictions)
                evaluated.add(checkpoint)
            time.sleep(args.watch)

    _evaluator(args).evaluate(args.output, checkpoint=args.checkpoint,
                              write_predictions=args.write_predictions)


if __name__ == '__main__':
    main()
