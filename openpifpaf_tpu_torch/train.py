"""Train CLI of the port (counterpart of ``openpifpaf_tpu/train.py``).

Runs on the first CUDA device unless ``--device cpu`` is given; without a
card the default raises.

Example:
    python -m openpifpaf_tpu_torch.train --dataset cocokp --basenet shufflenetv2k16
"""

import argparse
import datetime
import logging
import os
import socket

import torch

from . import __version__, datasets, encoder, logger
from .models import factory as models_factory
from .training import checkpoint as ckpt_mod
from .training import losses, optimize
from .training.trainer import Trainer

LOG = logging.getLogger(__name__)


def default_output_file(args):
    base_name = args.basenet or 'default'
    now = datetime.datetime.now().strftime('%y%m%d-%H%M%S')
    out = f'outputs/{base_name}-{now}-{args.dataset}'
    # queued cluster jobs may start at the same second; disambiguate with
    # the job id
    if os.getenv('SLURM_JOB_ID'):
        out += f'-slurm{os.getenv("SLURM_JOB_ID")}'
    return out


def cli(argv=None):
    parser = argparse.ArgumentParser(
        prog='python3 -m openpifpaf_tpu_torch.train',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument('--version', action='version',
                        version=f'OpenPifPaf-TPU (PyTorch) {__version__}')
    parser.add_argument('--output', default=None, help='output file')
    parser.add_argument('--dataset', default='cocokp')
    parser.add_argument('--dataset-weights', default=None, nargs='+',
                        type=float,
                        help='round-robin sampling weights of the '
                             'datasets of a multi-dataset --dataset a-b')
    parser.add_argument('--basenet', default='shufflenetv2k16')
    parser.add_argument('--checkpoint', default=None,
                        help='resume or fine-tune from a checkpoint of '
                             'the port, a reference .pkl or a published '
                             'name')
    parser.add_argument('--upsample', default=1, type=int,
                        help='head upsample stride')
    parser.add_argument('--batch-size', default=8, type=int)
    parser.add_argument('--loader-workers', default=0, type=int)
    parser.add_argument('--device', default='cuda',
                        help='torch device to train on; "cpu" runs on the '
                             'CPU (the counterpart of JAX_PLATFORMS=cpu)')
    parser.add_argument('--n-devices', default=None, type=int,
                        help='not yet ported: more than one device '
                             '(ROADMAP A12)')
    parser.add_argument('--spatial-partitions', default=1, type=int,
                        help='not yet ported: more than 1 (ROADMAP A12)')
    parser.add_argument('--seed', default=42, type=int)
    parser.add_argument('--profile', default=None, nargs='?',
                        const='torch_trace',
                        help='write a torch.profiler Chrome trace of each '
                             'train step to <prefix>.<n>.json')
    parser.add_argument('--debug', default=False, action='store_true')

    logger.cli(parser)
    Trainer.cli(parser)
    optimize.cli(parser)
    models_factory.cli(parser)
    losses.Factory.cli(parser)
    encoder.cli(parser)
    for dm in datasets.datamodules().values():
        dm.cli(parser)

    args = parser.parse_args(argv)
    if args.n_devices not in (None, 1) or args.spatial_partitions != 1:
        raise NotImplementedError(
            'training on a device mesh (--n-devices, --spatial-partitions) '
            'is not yet ported to PyTorch (ROADMAP A12)')

    if args.output is None:
        args.output = default_output_file(args)
        os.makedirs('outputs', exist_ok=True)

    logger.configure(args, LOG)
    Trainer.configure(args)
    models_factory.configure(args)
    losses.Factory.configure(args)
    encoder.configure(args)
    for dm in datasets.datamodules().values():
        dm.configure(args)
    return args


def main(argv=None):
    """Train as the command line says; returns the Trainer."""
    args = cli(argv)
    if args.device.startswith('cuda') and not torch.cuda.is_available():
        raise RuntimeError('train: no CUDA device found; pass --device cpu '
                           'to train on the CPU')

    datasets.MultiDataModule.weights = args.dataset_weights
    datamodule = datasets.factory(args.dataset)
    datamodule.batch_size = args.batch_size
    datamodule.loader_workers = args.loader_workers

    if args.checkpoint:
        args.checkpoint = models_factory.resolve_checkpoint(args.checkpoint)
        model, loaded_meta = ckpt_mod.load_shell(
            args.checkpoint, head_metas=datamodule.head_metas,
            head_consolidation=models_factory.HEAD_CONSOLIDATION)
        # resume from the checkpoint's epoch
        start_epoch = int(loaded_meta.get('epoch') or 0)
        # the checkpoint's architecture wins over the --basenet default so
        # that checkpoints written by this run remain loadable
        if loaded_meta.get('base_name'):
            args.basenet = loaded_meta['base_name']
        backbone_options = loaded_meta.get('backbone_options') or {}
        models_factory.SHUFFLENETV2K_OPTIONS.update(
            backbone_options.get('shufflenetv2k', {}))
        models_factory.RESNET_OPTIONS.update(
            backbone_options.get('resnet', {}))
    else:
        net_factory = models_factory.Factory(
            base_name=args.basenet, upsample_stride=args.upsample)
        model = net_factory.from_scratch(
            datamodule.head_metas,
            generator=torch.Generator().manual_seed(args.seed))
        start_epoch = 0

    loss_fn = losses.Factory().factory(datamodule.head_metas)

    train_loader = datamodule.train_loader()
    val_loader = datamodule.val_loader()
    LOG.info('training batches: %d, validation batches: %d',
             len(train_loader), len(val_loader))

    optimizer, schedule = optimize.factory_optimizer(
        args, training_batches_per_epoch=len(train_loader))

    trainer = Trainer(
        model, loss_fn, optimizer, schedule, args.output,
        device=args.device,
        model_meta_data={
            'base_name': args.basenet,
            'backbone_options': {
                'shufflenetv2k': dict(models_factory.SHUFFLENETV2K_OPTIONS),
                'resnet': dict(models_factory.RESNET_OPTIONS),
            },
            'head_metas': [ckpt_mod.headmeta_to_dict(m)
                           for m in datamodule.head_metas],
            'args': vars(args),
            'version': __version__,
            'hostname': socket.gethostname(),
        })
    if args.profile:
        from .profiler import TorchProfiler
        trainer.train_step = TorchProfiler(trainer.train_step,
                                           out_name=args.profile,
                                           device=args.device)
    trainer.loop(train_loader, val_loader, start_epoch)
    return trainer


if __name__ == '__main__':
    main()
