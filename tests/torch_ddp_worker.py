"""One rank of the port's two-process gloo data-parallel train step
(``tests/test_torch_parallel.py``); imports torch, never JAX.

    python torch_ddp_worker.py RANK WORLD_SIZE PORT WORKDIR

``WORKDIR`` holds ``batch.npz`` (the global batch: ``images``, ``cif``,
``caf``, and ``bn_x``/``bn_grad`` for the BatchNorm check) and
``start.pt`` (the narrow model's initial state dict). The rank trains on
its shard of the batch for :data:`STEPS` steps under
``DistributedDataParallel`` with the cross-rank BatchNorm and the
running-variance normaliser, and writes ``rank<R>.pt``: each step's loss
and components, the final state dict, EMA and loss state, and the
cross-rank BatchNorm's output and gradients on its shard of ``bn_x``.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

#: the steps of the comparison
STEPS = 2
#: optimizer flags of the comparison: a learning rate at which the
#: parameters move far beyond the comparison's tolerance in two steps
OPT = dict(lr=1e-3)


def build_trainer(start, process_group=None):
    """The narrow k16 from ``start`` in float64 (so that the comparison
    sees the ranks' reductions, not float32's rounding) with the
    running-variance loss and SGD at :data:`OPT`, on the CPU."""
    from openpifpaf_tpu_torch.training import losses, optimize
    from openpifpaf_tpu_torch.training.trainer import Trainer
    from torch_port_helpers import optimizer_args, port_metas, \
        port_narrow_shell

    model = port_narrow_shell(port_metas(16))
    model.load_state_dict(start)
    model.double()
    factory = losses.Factory()
    factory.auto_tune_mtl_variance = True
    optimizer, schedule = optimize.factory_optimizer(
        optimizer_args(**OPT), training_batches_per_epoch=1)
    return Trainer(model, factory.factory(port_metas(16)), optimizer,
                   schedule, 'unused', device='cpu',
                   process_group=process_group)


def train(trainer, images, targets):
    """Each step's (loss, components) as floats, the batch in float64."""
    images = images.double()
    targets = tuple(t.double() for t in targets)
    history = []
    for _ in range(STEPS):
        loss, head_losses = trainer.train_step(images, targets)
        history.append([float(loss)] + [float(l) for l in head_losses])
    return history


def main(rank, world_size, port, workdir):
    from openpifpaf_tpu_torch import parallel
    from openpifpaf_tpu_torch.parallel.batch_norm import \
        cross_rank_batch_norm

    torch.set_num_threads(1)
    group = parallel.initialize_multihost(
        'cpu', init_method=f'tcp://localhost:{port}',
        world_size=world_size, rank=rank)
    batch = np.load(os.path.join(workdir, 'batch.npz'))
    shard = parallel.local_batch_slice(batch['images'].shape[0])
    images = torch.from_numpy(batch['images'][shard])
    targets = (torch.from_numpy(batch['cif'][shard]),
               torch.from_numpy(batch['caf'][shard]))
    trainer = build_trainer(torch.load(os.path.join(workdir, 'start.pt')),
                            group)
    history = train(trainer, images, targets)

    bn_shard = parallel.local_batch_slice(batch['bn_x'].shape[0])
    x = torch.from_numpy(batch['bn_x'][bn_shard]).requires_grad_()
    c = x.shape[1]
    weight = torch.linspace(0.5, 1.5, c, dtype=x.dtype).requires_grad_()
    bias = torch.linspace(-0.2, 0.2, c, dtype=x.dtype).requires_grad_()
    y, mean, var = cross_rank_batch_norm(x, weight, bias, 1e-3, group)
    y.backward(torch.from_numpy(batch['bn_grad'][bn_shard]))

    torch.save({
        'history': history,
        'state': trainer.model.state_dict(),
        'ema': [e.clone() for e in trainer.ema],
        'loss_state': dict(trainer.loss_state),
        'bn': {'y': y.detach(), 'mean': mean, 'var': var,
               'grad_x': x.grad, 'grad_weight': weight.grad,
               'grad_bias': bias.grad},
    }, os.path.join(workdir, f'rank{rank}.pt'))
    torch.distributed.destroy_process_group()


if __name__ == '__main__':
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
