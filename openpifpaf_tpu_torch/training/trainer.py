"""Trainer (port of ``openpifpaf_tpu/training/trainer.py``).

One train step is the JAX package's ``build_train_step`` as eager PyTorch
on one device: forward in train mode, loss, backward, the inf-norm
gradient clip scaled by the learning rate, the optimizer update, the EMA
``ema = (1 - d) * ema + d * p`` of the parameters, and the BatchNorm
running statistics folded in with flax's rule. The trainer holds the
model, the loss's own parameters (the Kendall log-sigmas) and its state
(the variance buffer), the optimizer and its ``LambdaLR``, the EMA copy,
the step counter and, with ``--stride-apply``, the accumulated gradients
(in the parameters' ``.grad``). Checkpoints carry the EMA parameters.

With a ``process_group`` the step is data-parallel, the counterpart of
JAX's step on a data mesh: the forward and the loss run as one module
under ``DistributedDataParallel`` (DDP averages the gradients of the
model and of the loss's log-sigmas), the BatchNorms normalise over every
rank's batch, the running-variance normaliser moves with the mean of the
ranks' losses, and the logged losses are those means. Each rank's batch
is its shard of the global batch; the per-head losses divide by the
rank's batch size, so the averaged gradient is the global batch's. Only
rank 0 writes checkpoints.

With ``spatial`` above 1 the step runs on JAX's ``('data', 'space')``
mesh: each image's height is split over ``spatial`` shards, all on the
trainer's device in one process, or one per rank with a process group
(rank r at data index r // spatial, space index r % spatial; the ranks of
a data index load the same batch). The forward runs on each shard's rows
with halo exchanges (``parallel.spatial_model``), the BatchNorm statistics
are taken over every shard's owned rows and every rank, and the fields
are gathered along fh before the loss, so that the loss code stays as it
is: each rank of a space axis computes the same loss on the same fields
and targets, equal to JAX's sharded loss, a sum over the cells. A
parameter's gradient is then summed over the space axis, where each
shard holds its rows' share, and averaged over the data axis: the
gather's backward hands each rank its rows' gradient times the number of
ranks of its space axis, and DDP averages over all ranks. The loss's own
parameters, equal on the ranks of a space axis, come out of DDP's average
as they are.
"""

import logging
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..models.basenetworks import (commit_batch_stats, discard_batch_stats,
                                   set_batch_norm_group)
from ..parallel import spatial_model
from ..parallel.mesh import GridMesh, rank_mean

LOG = logging.getLogger(__name__)

#: seed of the heads' dropout generator (the JAX step folds the step
#: into ``PRNGKey(4242)``; the two streams cannot match bit for bit)
DROPOUT_SEED = 4242


def head_sparsity_penalty(model):
    """L1 sparsity on head conv kernels: max over input channels (dim 1
    of a torch (cout, cin, kh, kw) weight, axis 2 of a flax kernel),
    clamped, summed."""
    total = 0.0
    for head in model.head_nets:
        for p in head.parameters():
            if p.dim() == 4:
                total = total + torch.sum(torch.clamp(
                    torch.amax(torch.abs(p), dim=1), min=1e-6))
    return total


def _accumulate_head_losses(sums, counts, head_losses):
    """Running per-field sums/counts; None entries (heads of other
    datasets in multi-dataset training) don't contribute."""
    values = [float(l) if l is not None else None for l in head_losses]
    if sums is None:
        sums = [0.0] * len(values)
        counts = [0] * len(values)
    for i, v in enumerate(values):
        if v is not None and np.isfinite(v):
            sums[i] += v
            counts[i] += 1
    return sums, counts


class _StepModule(nn.Module):
    """The train forward and the loss as one module, the unit that DDP
    wraps: it holds the model and the loss's parameters."""

    def __init__(self, trainer):
        super().__init__()
        self.model = trainer.model
        self.loss_params = nn.ParameterDict(trainer.loss_params)
        self._forward = trainer._forward
        self.loss_fn = trainer.loss_fn

    def forward(self, images, targets, head_mask, bn_train, loss_state):
        outputs = self._forward(images, head_mask, bn_train)
        return self.loss_fn(outputs, targets, dict(self.loss_params),
                            loss_state)


def _mean_head_losses(sums, counts):
    if sums is None:
        return []
    return [round(s / c, 5) if c else None for s, c in zip(sums, counts)]


class Trainer:
    epochs = None
    clip_grad_norm = 0.0
    clip_grad_value = 0.0
    cross_talk = 0.0
    log_interval = 11
    val_interval = 1
    ema_decay = 0.01
    stride_apply = 1
    remat = False
    fix_batch_norm = False  # False | True | epoch number
    bf16 = False
    n_train_batches = None
    n_val_batches = None

    def __init__(self, model, loss_fn, optimizer, schedule, out, *,
                 device=None, model_meta_data=None, process_group=None,
                 spatial=1):
        """``optimizer`` builds the optimizer and its scheduler from the
        trainable tensors (``optimize.OptimizerFactory``); ``schedule``
        is the learning rate as a function of the step. The model is
        moved to ``device`` (default: where its parameters are).
        ``process_group``: train data-parallel over its ranks (see the
        module's docstring); rank 0's parameters are broadcast.
        ``spatial``: shards of each image's height (the module's
        docstring)."""
        self.device = torch.device(device) if device is not None \
            else next(model.parameters()).device
        self.model = model.to(self.device)
        self.loss_fn = loss_fn
        self.schedule = schedule
        self.out = out
        self.model_meta_data = model_meta_data or {}
        self.process_group = process_group
        self.rank = dist.get_rank(process_group) \
            if process_group is not None else 0
        #: the space axis of the spatial step (None: not spatial)
        self.space, data_rank = self._space_axis(spatial)

        self.loss_params = {
            k: nn.Parameter(v.to(self.device))
            for k, v in loss_fn.init_params().items()}
        self.loss_state = {k: v.to(self.device)
                           for k, v in loss_fn.init_state().items()}
        self._step_module = _StepModule(self)
        if process_group is not None:
            # the statistics' collectives on a group of their own, apart
            # from DDP's gradient buckets
            set_batch_norm_group(model, dist.new_group(
                dist.get_process_group_ranks(process_group)))
            if hasattr(loss_fn, 'process_group'):
                loss_fn.process_group = process_group
            # broadcasts rank 0's parameters; the running statistics are
            # equal on every rank by construction
            self._step_module = nn.parallel.DistributedDataParallel(
                self._step_module, process_group=process_group,
                device_ids=[self.device] if self.device.type == 'cuda'
                else None,
                broadcast_buffers=False, find_unused_parameters=True)
        self.params = list(model.parameters()) + list(
            self.loss_params.values())
        self.optimizer, self.lr_scheduler = optimizer(self.params)
        self.ema = [p.detach().clone() for p in model.parameters()]
        #: the trainer's step counter: it drives the clip threshold and
        #: the logged lr, and advances on every step; the optimizer's
        #: lr comes from the scheduler, which advances on applied steps
        self.step = 0
        # one dropout stream per data index; rank 0's is the single
        # process's
        self.dropout_generator = torch.Generator(self.device).manual_seed(
            DROPOUT_SEED + data_rank)

    def _space_axis(self, spatial):
        """The space axis of the spatial step (None: not spatial) and this
        rank's data index, as the grid mesh lays the ranks out."""
        if spatial <= 1:
            return None, self.rank
        if self.remat:
            raise ValueError('--remat recomputes a block of one tensor; '
                             'the spatial step runs on shards of rows')
        group = self.process_group
        if group is None:
            mesh = GridMesh([self.device] * spatial, spatial)
            return mesh.space_axes()[0][1], 0
        mesh = GridMesh([self.device], spatial, group)
        # the halo messages on a group of their own, apart from DDP's and
        # the BatchNorm's collectives
        (data, axis), = mesh.space_axes(
            dist.new_group(dist.get_process_group_ranks(group)))
        return axis, data

    def _fix_bn_active(self, epoch):
        if self.fix_batch_norm is True:
            return True
        if self.fix_batch_norm is not False:
            return self.fix_batch_norm <= epoch
        return False

    @classmethod
    def cli(cls, parser):
        group = parser.add_argument_group('trainer')
        group.add_argument('--epochs', default=75, type=int)
        group.add_argument('--train-batches', default=None, type=int)
        group.add_argument('--val-batches', default=None, type=int)
        group.add_argument('--clip-grad-norm', default=cls.clip_grad_norm,
                           type=float)
        group.add_argument('--clip-grad-value', default=cls.clip_grad_value,
                           type=float)
        group.add_argument('--log-interval', default=cls.log_interval,
                           type=int)
        group.add_argument('--val-interval', default=cls.val_interval,
                           type=int)
        group.add_argument('--ema', default=cls.ema_decay, type=float)
        group.add_argument('--cross-talk', default=cls.cross_talk,
                           type=float,
                           help='[experimental] input cross-talk strength')
        group.add_argument('--stride-apply', default=cls.stride_apply,
                           type=int,
                           help='apply and reset gradients every n batches')
        group.add_argument('--remat', default=cls.remat, action='store_true',
                           help='recompute each backbone block in the '
                                'backward pass (torch.utils.checkpoint): '
                                'less activation memory, about one extra '
                                'forward of compute')
        group.add_argument('--fix-batch-norm',
                           default=False, const=True, type=int, nargs='?',
                           help='fix batch norm running statistics '
                                '(optionally specify start epoch)')
        group.add_argument('--bf16', default=False, action='store_true',
                           help='mixed-precision training: backbone in '
                                'bfloat16 under autocast, float32 master '
                                'weights and BatchNorm statistics, heads '
                                'and loss in float32')

    @classmethod
    def configure(cls, args):
        cls.epochs = args.epochs
        cls.n_train_batches = args.train_batches
        cls.n_val_batches = args.val_batches
        cls.clip_grad_norm = args.clip_grad_norm
        cls.clip_grad_value = args.clip_grad_value
        cls.log_interval = args.log_interval
        cls.val_interval = args.val_interval
        cls.ema_decay = args.ema
        cls.cross_talk = args.cross_talk
        cls.stride_apply = args.stride_apply
        cls.remat = args.remat
        cls.fix_batch_norm = args.fix_batch_norm
        cls.bf16 = args.bf16

    def _forward(self, images, head_mask, bn_train):
        """Head outputs in train mode; ``bf16`` runs the backbone under
        bfloat16 autocast and the heads on its float32 features."""
        model = self.model
        if self.space is not None:
            return self._spatial_forward(images, head_mask, bn_train,
                                         self.bf16)
        if not self.bf16:
            return model(images, train=True, head_mask=head_mask,
                         bn_train=bn_train, generator=self.dropout_generator,
                         remat=self.remat)
        with torch.autocast(images.device.type, dtype=torch.bfloat16):
            features = model.backbone(
                images, True if bn_train is None else bn_train,
                remat=self.remat)
        return model.heads(features.float(), train=True, head_mask=head_mask,
                           generator=self.dropout_generator)

    def _spatial_forward(self, images, head_mask, bn_train, bf16):
        """The train-mode fields of the spatial step, whole on every rank
        (the module's docstring)."""
        axis = self.space
        models = [self.model] * len(axis.local)
        rows = spatial_model.images_to_rows(images, axis)
        bn = True if bn_train is None else bn_train
        with torch.autocast(images.device.type, dtype=torch.bfloat16,
                            enabled=bf16):
            features = spatial_model.backbone_rows(
                [m.base_net for m in models], rows, bn)
        if bf16:
            features = features.map(lambda k, x: x.float())
        fields = spatial_model.heads_rows(
            [m.head_nets for m in models], features, train=True,
            head_mask=head_mask, generator=self.dropout_generator)
        return spatial_model.gather_fields(fields, self.device,
                                           scale=axis.n_ranks)

    def train_step(self, images, targets, *, fix_bn=False):
        """One step on a batch on the device: images (B, H, W, 3),
        targets per head (B, F, C, H', W') or None. Returns the loss and
        the per-component losses (detached tensors, None where a head
        has no target)."""
        head_mask = tuple(t is not None for t in targets)
        if self.cross_talk:
            # train-time input cross-talk augmentation: blend each image
            # with the previous batch element
            images = images + torch.roll(images, 1, dims=0) * self.cross_talk

        total, head_losses, new_loss_state = self._step_module(
            images, targets, head_mask, False if fix_bn else None,
            self.loss_state)
        task_sparsity_weight = getattr(self.loss_fn, 'task_sparsity_weight',
                                       0.0)
        if task_sparsity_weight:
            total = total + task_sparsity_weight * \
                head_sparsity_penalty(self.model)
        total.backward()
        commit_batch_stats(self.model)
        self.loss_state = {k: v.detach() for k, v in new_loss_state.items()}

        if self.stride_apply <= 1 or (self.step + 1) % self.stride_apply == 0:
            self._apply_gradients()
        self.step += 1
        return self._rank_mean(total, head_losses)

    def _rank_mean(self, total, head_losses):
        """The detached loss and components, averaged over the ranks in
        a data-parallel step (what the log and the finiteness check
        read, equal on every rank)."""
        values = [total.detach()] + [l.detach() if l is not None else None
                                     for l in head_losses]
        if self.process_group is not None:
            values = rank_mean(values, self.process_group)
        return values[0], values[1:]

    def _apply_gradients(self):
        """Clip, update and EMA from the gradients in ``.grad`` (summed
        over ``stride_apply`` steps). The clip threshold uses the
        trainer's counter, the update the scheduler's."""
        for p in self.params:
            if p.grad is None:
                # JAX's gradient of an unused leaf is zero, and momentum
                # and weight decay still act on it
                p.grad = torch.zeros_like(p)
        if self.clip_grad_norm:
            # inf-norm over every trainable tensor, the loss's log-sigmas
            # included: scale min(1, max_norm / (norm + 1e-6))
            lr = self.schedule(self.step)
            torch.nn.utils.clip_grad_norm_(
                self.params, self.clip_grad_norm / max(lr, 1e-12),
                norm_type=float('inf'))
        if self.clip_grad_value:
            torch.nn.utils.clip_grad_value_(self.params,
                                            self.clip_grad_value)
        self.optimizer.step()
        self.lr_scheduler.step()
        self.optimizer.zero_grad(set_to_none=True)
        with torch.no_grad():
            params = [p.detach() for p in self.model.parameters()]
            torch._foreach_mul_(self.ema, 1.0 - self.ema_decay)
            torch._foreach_add_(self.ema, params, alpha=self.ema_decay)

    def val_step(self, images, targets, *, fix_bn=False):
        """The loss in train mode without gradients; the batch's
        BatchNorm statistics and the loss state are thrown away, as the
        JAX step does."""
        head_mask = tuple(t is not None for t in targets)
        with torch.no_grad():
            if self.space is not None:
                outputs = self._spatial_forward(
                    images, head_mask, False if fix_bn else None, False)
            else:
                outputs = self.model(images, train=True, head_mask=head_mask,
                                     bn_train=False if fix_bn else None,
                                     generator=self.dropout_generator)
            total, head_losses, _ = self.loss_fn(
                outputs, targets, self.loss_params, self.loss_state)
            total, head_losses = self._rank_mean(total, head_losses)
        discard_batch_stats(self.model)
        return total, head_losses

    def ema_state_dict(self):
        """The model's state dict with the EMA parameters and the current
        BatchNorm buffers, on the CPU (what a checkpoint holds)."""
        state = {k: v.detach().cpu()
                 for k, v in self.model.state_dict().items()}
        for (name, _), ema in zip(self.model.named_parameters(), self.ema):
            state[name] = ema.cpu()
        return state

    def loop(self, train_loader, val_loader, start_epoch=0):
        # a config line names the per-head loss fields so the logs CLI
        # can label head-loss panels
        LOG.info({
            'type': 'config',
            'field_names': list(getattr(self.loss_fn, 'field_names', [])),
            'argv': sys.argv,
        })
        if start_epoch and self.step == 0:
            # resumed run: the trainer's counter (clip threshold, logged
            # lr) starts at the checkpoint's epoch, but the optimizer's
            # schedule starts at 0, as optax's count does in the JAX
            # package, which restores neither
            self.step = start_epoch * len(train_loader)
        for epoch in range(start_epoch, self.epochs):
            if epoch == 0:
                self.write_model(0, final=False)
            if hasattr(train_loader, 'set_epoch'):
                train_loader.set_epoch(epoch)
            self.train(train_loader, epoch)
            if (epoch + 1) % self.val_interval == 0 \
                    or epoch + 1 == self.epochs:
                self.write_model(epoch + 1, epoch + 1 == self.epochs)
                self.val(val_loader, epoch + 1)

    def _prepare_targets(self, targets, metas):
        """Per-head targets on the device, ordered by
        meta['head_indices']."""
        n_heads = len(self.model.head_nets)
        head_indices = metas[0].get('head_indices',
                                    list(range(len(targets))))
        if len(targets) == n_heads and len(head_indices) < n_heads:
            # already expanded into global head slots (None marks heads
            # of other datasets)
            return tuple(self._to_device(t) if t is not None else None
                         for t in targets)
        out = [None] * n_heads
        for t, head_i in zip(targets, head_indices):
            out[head_i] = self._to_device(t)
        return tuple(out)

    def _to_device(self, array):
        return torch.from_numpy(np.asarray(array)).to(self.device,
                                                       non_blocking=True)

    def train(self, loader, epoch):
        fix_bn = self._fix_bn_active(epoch)
        if fix_bn:
            LOG.info('fix batchnorm')
        start_time = time.time()
        epoch_loss = 0.0
        epoch_head_losses = None
        epoch_head_counts = None
        n = 0
        last_batch_start = time.time()
        for batch_i, (images, targets, metas) in enumerate(loader):
            if self.n_train_batches and batch_i >= self.n_train_batches:
                break
            data_time = time.time() - last_batch_start

            targets = self._prepare_targets(targets, metas)
            loss, head_losses = self.train_step(
                self._to_device(images), targets, fix_bn=fix_bn)

            if batch_i % self.log_interval == 0:
                loss_v = float(loss)
                lr = float(self.schedule(self.step - 1))
                LOG.info({
                    'type': 'train', 'epoch': epoch, 'batch': batch_i,
                    'n_batches': len(loader),
                    'time': round(time.time() - last_batch_start, 3),
                    'data_time': round(data_time, 3),
                    'lr': round(lr, 8),
                    'loss': round(loss_v, 3),
                    'head_losses': [round(float(l), 3) if l is not None
                                    else None for l in head_losses],
                    **({'mtl_sigmas': [
                        # effective clamped log-sigmas (the loss applies
                        # 3*tanh(x/3) before use)
                        round(float(3.0 * np.tanh(v / 3.0)), 3)
                        for v in self.loss_params['log_sigmas']
                        .detach().cpu().numpy()]}
                       if 'log_sigmas' in self.loss_params else {}),
                })
            loss_value = float(loss)
            if not np.isfinite(loss_value):
                # fail fast like the reference
                raise ValueError(
                    f'non-finite loss {loss_value} in epoch {epoch} '
                    f'batch {batch_i}')
            epoch_loss += loss_value
            epoch_head_losses, epoch_head_counts = _accumulate_head_losses(
                epoch_head_losses, epoch_head_counts, head_losses)
            n += 1
            last_batch_start = time.time()

        LOG.info({
            'type': 'train-epoch', 'epoch': epoch + 1,
            'loss': round(epoch_loss / max(1, n), 5),
            'head_losses': _mean_head_losses(epoch_head_losses,
                                             epoch_head_counts),
            'time': round(time.time() - start_time, 1),
            'n_batches': n,
        })

    def val(self, loader, epoch):
        # the fix-BN check in val uses epoch - 1, as in the reference
        fix_bn = self._fix_bn_active(epoch - 1)
        start_time = time.time()
        epoch_loss = 0.0
        head_sums = None
        head_counts = None
        n = 0
        for batch_i, (images, targets, metas) in enumerate(loader):
            if self.n_val_batches and batch_i >= self.n_val_batches:
                break
            targets = self._prepare_targets(targets, metas)
            loss, head_losses = self.val_step(
                self._to_device(images), targets, fix_bn=fix_bn)
            epoch_loss += float(loss)
            head_sums, head_counts = _accumulate_head_losses(
                head_sums, head_counts, head_losses)
            n += 1
        LOG.info({
            'type': 'val-epoch', 'epoch': epoch,
            'loss': round(epoch_loss / max(1, n), 5),
            'head_losses': _mean_head_losses(head_sums, head_counts),
            'time': round(time.time() - start_time, 1),
            'n_batches': n,
        })

    def write_model(self, epoch, final=True):
        if self.rank != 0:
            return
        from . import checkpoint as ckpt_mod
        filename = f'{self.out}.epoch{epoch:03d}'
        LOG.debug('about to write model %s', filename)
        # the EMA weights go into the saved model
        state_dict = self.ema_state_dict()
        meta = {**self.model_meta_data, 'epoch': epoch}
        ckpt_mod.save(filename, state_dict=state_dict, meta=meta)
        if final:
            ckpt_mod.save(self.out, state_dict=state_dict, meta=meta)
        LOG.info('model written: %s', filename)
