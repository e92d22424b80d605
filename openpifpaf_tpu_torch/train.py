"""Train CLI of the port (counterpart of ``openpifpaf_tpu/train.py``).

Runs on the first CUDA device unless ``--device cpu`` is given; without a
card the default raises.

Data-parallel training (``DistributedDataParallel``, one process per
device): ``--n-devices N`` spawns N ranks on ``cuda:0`` .. ``cuda:N-1``
(or N gloo ranks with ``--device cpu``); by default every visible card
takes part, and with one card the step is the plain single-process one.
A launch by ``torchrun --nproc-per-node N -m openpifpaf_tpu_torch.train``
is found from its environment. ``--batch-size`` is the global batch: each
rank loads its shard. Only rank 0 writes checkpoints and the log.
``--spatial-partitions S`` makes the ranks a ``('data', 'space')`` mesh:
each image's height is split over S ranks (rank r at data index r // S,
space index r % S) and the batch over the N / S data indices. As in JAX,
a ``--batch-size`` times S below the devices shrinks the mesh to
``max(S, batch size x S)`` ranks, with a warning.

Example:
    python -m openpifpaf_tpu_torch.train --dataset cocokp --basenet shufflenetv2k16
"""

import argparse
import datetime
import logging
import os
import socket
import sys

import numpy as np
import torch
import torch.distributed as dist

from . import __version__, datasets, encoder, logger, parallel
from .models import factory as models_factory
from .models.basenetworks import set_batch_norm_group
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
                        help='train data-parallel over this many ranks, '
                             'one process per device (default: every '
                             'visible CUDA device; with one, a single '
                             'process); 1 runs the data-parallel step on '
                             'one device')
    parser.add_argument('--spatial-partitions', default=1, type=int,
                        help='split each image\'s height over this many '
                             'of the ranks (halo exchanges); the batch is '
                             'split over the rest')
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
    if args.n_devices is not None and args.n_devices < 1:
        parser.error('--n-devices must be at least 1')
    if args.spatial_partitions < 1:
        parser.error('--spatial-partitions must be at least 1')

    if args.output is None:
        args.output = default_output_file(args)
        os.makedirs('outputs', exist_ok=True)

    if int(os.environ.get('RANK', '0')) > 0:
        # only rank 0 writes the log
        log_args = argparse.Namespace(**vars(args))
        log_args.output = None
        log_args.quiet = True
        logger.configure(log_args, LOG)
    else:
        logger.configure(args, LOG)
    Trainer.configure(args)
    models_factory.configure(args)
    losses.Factory.configure(args)
    encoder.configure(args)
    for dm in datasets.datamodules().values():
        dm.configure(args)
    return args


def _free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _spawned_rank(index, argv, world_size, port):
    """A rank that ``main`` spawned: torchrun's environment, then main."""
    os.environ.update(RANK=str(index), LOCAL_RANK=str(index),
                      WORLD_SIZE=str(world_size), MASTER_ADDR='localhost',
                      MASTER_PORT=str(port))
    main(argv)


def _process_group(args, argv):
    """The ranks of this run: ``(group, rank, world_size, device)``,
    group None in a single process; ``(None, None, n, None)`` when this
    process is to spawn ``n`` ranks."""
    device_type = torch.device(args.device).type
    if 'WORLD_SIZE' in os.environ:
        group = parallel.initialize_multihost(device_type)
        rank = dist.get_rank()
        device = args.device
        if device_type == 'cuda':
            device = torch.device('cuda',
                                  int(os.environ.get('LOCAL_RANK', rank)))
            torch.cuda.set_device(device)
        return group, rank, dist.get_world_size(), device
    n = args.n_devices
    spatial = args.spatial_partitions
    if n is None:
        n = torch.cuda.device_count() if device_type == 'cuda' else 1
        if n <= 1 and spatial == 1:
            return None, 0, 1, args.device
    if args.batch_size * spatial < n:
        LOG.warning('batch size %d x spatial %d < %d devices: shrinking the '
                    'data mesh', args.batch_size, spatial, n)
        n = max(spatial, args.batch_size * spatial)
    if n % spatial:
        raise ValueError(f'{n} devices not divisible by spatial={spatial}')
    if device_type == 'cuda' and n > torch.cuda.device_count():
        raise ValueError(f'--n-devices {n}: only '
                         f'{torch.cuda.device_count()} CUDA devices visible')
    if n > 1:
        return None, None, n, None
    group = parallel.initialize_multihost(
        device_type, init_method=f'tcp://localhost:{_free_port()}',
        world_size=1, rank=0)
    device = torch.device(args.device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    return group, 0, 1, device


def main(argv=None):
    """Train as the command line says; returns the Trainer (None in a
    process that spawned the ranks)."""
    if argv is None:
        argv = sys.argv[1:]
    args = cli(argv)
    if args.device.startswith('cuda') and not torch.cuda.is_available():
        raise RuntimeError('train: no CUDA device found; pass --device cpu '
                           'to train on the CPU')

    group, rank, world_size, device = _process_group(args, argv)
    if rank is None:
        LOG.info('spawning %d ranks', world_size)
        torch.multiprocessing.start_processes(
            _spawned_rank, args=(argv, world_size, _free_port()),
            nprocs=world_size, start_method='spawn')
        return None
    spatial = args.spatial_partitions
    # the ranks of one data index load the same batch
    mesh = parallel.GridMesh([device], spatial, group)
    (n_data, _), ((data_rank, _),) = mesh.shape, mesh.cells()
    if args.batch_size % n_data:
        raise ValueError(f'--batch-size {args.batch_size} (the global '
                         f'batch) not divisible by {n_data} data ranks')
    if group is not None:
        # each data index's augmentations draw from a stream of its own
        np.random.seed(parallel.rank_seed(args.seed, data_rank))

    datasets.MultiDataModule.weights = args.dataset_weights
    datamodule = datasets.factory(args.dataset)
    datamodule.batch_size = args.batch_size // n_data
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
    if group is not None:
        parallel.shard_loader(train_loader, data_rank, n_data)
        parallel.shard_loader(val_loader, data_rank, n_data)
    LOG.info('training batches: %d, validation batches: %d',
             len(train_loader), len(val_loader))

    optimizer, schedule = optimize.factory_optimizer(
        args, training_batches_per_epoch=len(train_loader))

    trainer = Trainer(
        model, loss_fn, optimizer, schedule, args.output,
        device=device, process_group=group, spatial=spatial,
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
                                           device=device)
    try:
        trainer.loop(train_loader, val_loader, start_epoch)
    finally:
        if group is not None:
            # the returned trainer's model normalises on its own again
            set_batch_norm_group(model, None)
            dist.destroy_process_group()
    return trainer


if __name__ == '__main__':
    main()
