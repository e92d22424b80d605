"""Optimizer and LR schedule factories (port of
``openpifpaf_tpu/training/optimize.py``).

``torch.optim`` replaces optax: SGD (momentum, Nesterov, no dampening) or
Adam, with optax's ``add_decayed_weights`` as torch's coupled
``weight_decay`` over one parameter group, under a ``LambdaLR`` that the
trainer steps once per applied update, as optax's count advances. The
schedule (warm-up, stepped exponential decays, warm restarts) is a plain
function of the step index.
"""

import argparse
import logging

import torch

LOG = logging.getLogger(__name__)


def cli(parser: argparse.ArgumentParser):
    group = parser.add_argument_group('optimizer')
    group.add_argument('--momentum', type=float, default=0.9)
    group.add_argument('--beta2', type=float, default=0.999)
    group.add_argument('--adam-eps', type=float, default=1e-6)
    group.add_argument('--no-nesterov', dest='nesterov', default=True,
                       action='store_false')
    group.add_argument('--weight-decay', type=float, default=0.0)
    group.add_argument('--adam', action='store_true')
    group.add_argument('--amsgrad', action='store_true')

    group_s = parser.add_argument_group('learning rate scheduler')
    group_s.add_argument('--lr', type=float, default=1e-3)
    group_s.add_argument('--lr-decay', default=[], nargs='+', type=float)
    group_s.add_argument('--lr-decay-factor', default=0.1, type=float)
    group_s.add_argument('--lr-decay-epochs', default=1.0, type=float)
    group_s.add_argument('--lr-warm-up-start-epoch', default=0, type=float)
    group_s.add_argument('--lr-warm-up-epochs', default=1, type=float)
    group_s.add_argument('--lr-warm-up-factor', default=0.001, type=float)
    group_s.add_argument('--lr-warm-restarts', default=[], nargs='+',
                         type=float)
    group_s.add_argument('--lr-warm-restart-duration', default=0.5,
                         type=float)


class LearningRateLambda:
    """LR multiplier as a function of the (fractional) step index:
    exponential ramp-in warm-up, smooth stepped decay over
    ``decay_epochs``, warm restarts. The JAX version evaluates the same
    expressions in float32 ``jnp.where`` chains; this one in Python
    floats."""

    def __init__(self, decay_schedule, *, decay_factor=0.1, decay_epochs=1.0,
                 warm_up_start_epoch=0, warm_up_epochs=2.0,
                 warm_up_factor=0.01, warm_restart_schedule=(),
                 warm_restart_duration=0.5):
        self.decay_schedule = decay_schedule
        self.decay_factor = decay_factor
        self.decay_epochs = decay_epochs
        self.warm_up_start_epoch = warm_up_start_epoch
        self.warm_up_epochs = warm_up_epochs
        self.warm_up_factor = warm_up_factor
        self.warm_restart_schedule = warm_restart_schedule
        self.warm_restart_duration = warm_restart_duration

    def __call__(self, step_i):
        step_i = float(step_i)
        lambda_ = 1.0

        w0 = self.warm_up_start_epoch
        we = self.warm_up_epochs
        if step_i <= w0:
            lambda_ *= self.warm_up_factor
        elif step_i < w0 + we:
            lambda_ *= self.warm_up_factor ** (1.0 - (step_i - w0) / we)

        for d in self.decay_schedule:
            if step_i >= d + self.decay_epochs:
                lambda_ *= self.decay_factor
            elif step_i > d:
                lambda_ *= self.decay_factor ** (
                    (step_i - d) / self.decay_epochs)

        for r in self.warm_restart_schedule:
            if r <= step_i < r + self.warm_restart_duration:
                lambda_ = lambda_ ** ((step_i - r)
                                      / self.warm_restart_duration)

        return lambda_


def lambda_from_args(args, training_batches_per_epoch):
    return LearningRateLambda(
        [s * training_batches_per_epoch for s in args.lr_decay],
        decay_factor=args.lr_decay_factor,
        decay_epochs=args.lr_decay_epochs * training_batches_per_epoch,
        warm_up_start_epoch=(args.lr_warm_up_start_epoch
                             * training_batches_per_epoch),
        warm_up_epochs=args.lr_warm_up_epochs * training_batches_per_epoch,
        warm_up_factor=args.lr_warm_up_factor,
        warm_restart_schedule=[r * training_batches_per_epoch
                               for r in args.lr_warm_restarts],
        warm_restart_duration=(args.lr_warm_restart_duration
                               * training_batches_per_epoch),
    )


def schedule_from_args(args, training_batches_per_epoch):
    """The learning rate as a function of the step."""
    lr_lambda = lambda_from_args(args, training_batches_per_epoch)
    return lambda step: args.lr * lr_lambda(step)


class OptimizerFactory:
    """Builds the optimizer and its ``LambdaLR`` over the trainable
    tensors once the trainer knows them (torch optimizers hold their
    parameters; optax transformations do not)."""

    def __init__(self, args, lr_lambda):
        self.adam = args.adam or args.amsgrad
        self.lr = args.lr
        self.momentum = args.momentum
        self.beta2 = args.beta2
        self.adam_eps = args.adam_eps
        self.nesterov = args.nesterov
        self.weight_decay = args.weight_decay
        self.lr_lambda = lr_lambda

    def __call__(self, params):
        params = list(params)
        if self.adam:
            # --amsgrad means plain Adam, as in the JAX package (it sets
            # adam and never passes amsgrad on); b1 is --momentum
            LOG.info('Adam optimizer')
            optimizer = torch.optim.Adam(
                params, lr=self.lr, betas=(self.momentum, self.beta2),
                eps=self.adam_eps, weight_decay=self.weight_decay)
        else:
            LOG.info('SGD optimizer')
            # without momentum Nesterov's update is the plain one (torch
            # refuses the combination, optax traces with decay 0)
            optimizer = torch.optim.SGD(
                params, lr=self.lr, momentum=self.momentum, dampening=0.0,
                nesterov=self.nesterov and self.momentum > 0.0,
                weight_decay=self.weight_decay)
        scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer,
                                                      self.lr_lambda)
        return optimizer, scheduler


def factory_optimizer(args, *, training_batches_per_epoch=1):
    """(optimizer factory, schedule): ``factory(params)`` gives the
    optimizer and its scheduler; ``schedule(step)`` the learning rate."""
    lr_lambda = lambda_from_args(args, training_batches_per_epoch)
    return (OptimizerFactory(args, lr_lambda),
            lambda step: args.lr * lr_lambda(step))
