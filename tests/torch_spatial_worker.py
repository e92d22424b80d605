"""One rank of the port's two-process gloo spatial mesh
(``tests/test_torch_spatial.py``); imports torch, never JAX.

    python torch_spatial_worker.py RANK WORLD_SIZE PORT WORKDIR

Rank r holds shard r of each image's height (data 1 x space 2). The rank
runs, and writes to ``WORKDIR/rank<R>.pt``:

- ``gradcheck``: ``torch.autograd.gradcheck`` in float64 of the remote
  side of the halo exchange (``parallel.spatial._Exchange``): the input
  is whole and the same on both ranks (so that both perturb the same
  element in step), each rank exchanges its shard's halo with the other
  and the tiles of both shards are gathered whole on both ranks; the
  input's gradient is summed over the ranks, as a replicated tensor's;
- ``tiles``: the forward of that exchange, for the test to hold against
  the local side;
- ``history``, ``state``: two spatial train steps of the start state in
  ``WORKDIR/start.pt`` (resnet18 with the cocokp heads, float32) on the
  global batch in ``WORKDIR/batch.npz``, through ``Trainer(...,
  spatial=2)`` under DDP.
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

#: the shape of the exchange's gradcheck: (N, C, H, W) and the halo
CHECK_SHAPE = (1, 2, 7, 3)
CHECK_HALO = 2
#: the steps of the comparison
STEPS = 2


class _Replicated(torch.autograd.Function):
    """The identity of a tensor that every rank holds whole; its gradient
    is summed over the ranks."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def exchanged_tiles(x, axis):
    """Every shard's halo tile of ``x`` (whole, on every rank), gathered
    whole on this rank: the tiles in shard order, concatenated along H."""
    from openpifpaf_tpu_torch.parallel import spatial
    rows = spatial.Rows.split(_Replicated.apply(x), axis)
    want = [(max(s - CHECK_HALO, 0), min(e + CHECK_HALO, rows.height))
            for s, e in rows.ranges]
    tiles = spatial.exchange(rows, want)
    starts = [int(c) for c in np.cumsum([0] + [b - a for a, b in want])]
    tiled = spatial.Rows(tiles, list(zip(starts[:-1], starts[1:])),
                         starts[-1], axis)
    return spatial.gather(tiled, x.device)


def build_trainer(start, spatial=1, process_group=None):
    """Resnet18 with the cocokp heads from ``start`` with SGD at lr 1e-3
    and a clip of 1, on the CPU."""
    from openpifpaf_tpu_torch.models.factory import Factory
    from openpifpaf_tpu_torch.training import losses, optimize
    from openpifpaf_tpu_torch.training.trainer import Trainer
    from torch_port_helpers import optimizer_args, port_metas

    model = Factory(base_name='resnet18').from_scratch(
        port_metas(16), generator=torch.Generator().manual_seed(0))
    model.load_state_dict(start)
    optimizer, schedule = optimize.factory_optimizer(
        optimizer_args(lr=1e-3), training_batches_per_epoch=1)
    trainer = Trainer(model, losses.Factory().factory(port_metas(16)),
                      optimizer, schedule, 'unused', device='cpu',
                      process_group=process_group, spatial=spatial)
    trainer.clip_grad_norm = 1.0
    return trainer


def train(trainer, batch):
    """Each step's loss; the batch whole."""
    images = torch.from_numpy(batch['images'])
    targets = (torch.from_numpy(batch['cif']), torch.from_numpy(batch['caf']))
    return [float(trainer.train_step(images, targets)[0])
            for _ in range(STEPS)]


def checksum(state):
    return float(sum(v.double().abs().sum() for k, v in state.items()
                     if v.is_floating_point()))


def main(rank, world_size, port, workdir):
    from openpifpaf_tpu_torch import parallel
    from openpifpaf_tpu_torch.parallel.spatial import SpaceAxis

    torch.set_num_threads(1)
    group = parallel.initialize_multihost(
        'cpu', init_method=f'tcp://localhost:{port}',
        world_size=world_size, rank=rank)
    axis = SpaceAxis(world_size, (rank,), (torch.device('cpu'),),
                     tuple(range(world_size)))

    x = torch.from_numpy(np.random.RandomState(3).randn(*CHECK_SHAPE))
    tiles = exchanged_tiles(x, axis).detach()
    gradcheck = torch.autograd.gradcheck(
        lambda t: exchanged_tiles(t, axis), (x.clone().requires_grad_(),),
        raise_exception=False)

    batch = np.load(os.path.join(workdir, 'batch.npz'))
    trainer = build_trainer(torch.load(os.path.join(workdir, 'start.pt')),
                            world_size, group)
    history = train(trainer, batch)
    state = {k: v.detach().clone()
             for k, v in trainer.model.state_dict().items()}
    torch.save({'gradcheck': gradcheck, 'tiles': tiles, 'history': history,
                'checksum': checksum(state), 'state': state},
               os.path.join(workdir, f'rank{rank}.pt'))
    dist.destroy_process_group()


if __name__ == '__main__':
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
