"""The port's learning-rate schedule and optimizers against the JAX
package's (optax).

``LearningRateLambda`` at every step under warm-up, decays and warm
restarts: rtol 1e-6 (the JAX version evaluates in float32). SGD with and
without Nesterov, Adam, ``--amsgrad`` (plain Adam in both) and weight
decay, each with the schedule, over 5 steps on the same parameters and
gradients: parameters within rtol 1e-5, atol 1e-7 after every step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from openpifpaf_tpu.training import optimize as jax_optimize
from openpifpaf_tpu_torch.training import optimize

from torch_port_helpers import optimizer_args

SCHEDULES = {
    'warm_up': dict(lr_warm_up_epochs=2, lr_warm_up_factor=0.01),
    'warm_up_start': dict(lr_warm_up_start_epoch=1, lr_warm_up_epochs=1.5),
    'decay': dict(lr_decay=[2, 4], lr_decay_epochs=1.5,
                  lr_decay_factor=0.2, lr_warm_up_epochs=0.5),
    'restarts': dict(lr_warm_restarts=[3, 5], lr_warm_restart_duration=1.0,
                     lr_decay=[1], lr_warm_up_epochs=1),
}


@pytest.mark.parametrize('name', sorted(SCHEDULES))
def test_schedule_matches_jax(name):
    args = optimizer_args(lr=0.02, **SCHEDULES[name])
    batches_per_epoch = 4
    ours = optimize.schedule_from_args(args, batches_per_epoch)
    ref = jax_optimize.schedule_from_args(args, batches_per_epoch)
    steps = np.arange(0, 8 * batches_per_epoch + 1)
    np.testing.assert_allclose([ours(s) for s in steps],
                               [float(ref(s)) for s in steps], rtol=1e-6)
    # fractional steps too (the lambda is a function of a real step)
    for s in (0.5, 2.25, 7.75, 12.5):
        assert ours(s) == pytest.approx(float(ref(s)), rel=1e-6)


def _params(seed):
    rng = np.random.RandomState(seed)
    return {'w': rng.randn(4, 3).astype(np.float32),
            'b': rng.randn(3).astype(np.float32)}


OPTIMIZERS = {
    'sgd_nesterov': dict(),
    'sgd': dict(nesterov=False, momentum=0.8),
    'sgd_no_momentum': dict(momentum=0.0),
    'sgd_weight_decay': dict(weight_decay=1e-2),
    'adam': dict(adam=True, momentum=0.85, beta2=0.99, adam_eps=1e-4),
    'amsgrad': dict(amsgrad=True),
    'adam_weight_decay': dict(adam=True, weight_decay=1e-3),
}


@pytest.mark.parametrize('name', sorted(OPTIMIZERS))
def test_optimizer_steps_match_optax(name):
    flags = dict(lr=0.05, lr_warm_up_epochs=2, lr_decay=[3], **OPTIMIZERS[name])
    batches_per_epoch = 2
    jax_opt, jax_schedule = jax_optimize.factory_optimizer(
        optimizer_args(**flags), training_batches_per_epoch=batches_per_epoch)
    factory, schedule = optimize.factory_optimizer(
        optimizer_args(**flags), training_batches_per_epoch=batches_per_epoch)

    params = _params(0)
    jax_params = jax.tree_util.tree_map(jnp.asarray, params)
    state = jax_opt.init(jax_params)
    tensors = {k: torch.tensor(v, requires_grad=True)
               for k, v in params.items()}
    optimizer, scheduler = factory(tensors.values())
    assert all(not group.get('amsgrad', False)
               for group in optimizer.param_groups)

    for step in range(5):
        grads = _params(100 + step)
        assert optimizer.param_groups[0]['lr'] == pytest.approx(
            float(jax_schedule(step)), rel=1e-6)
        assert schedule(step) == pytest.approx(float(jax_schedule(step)),
                                               rel=1e-6)
        updates, state = jax_opt.update(
            jax.tree_util.tree_map(jnp.asarray, grads), state, jax_params)
        jax_params = optax.apply_updates(jax_params, updates)
        for k, t in tensors.items():
            t.grad = torch.from_numpy(grads[k])
        optimizer.step()
        scheduler.step()
        for k, t in tensors.items():
            np.testing.assert_allclose(t.detach().numpy(),
                                       np.asarray(jax_params[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=f'{k} step {step}')


def test_optimizer_flags_match_jax():
    import argparse
    parsers = []
    for package in (optimize, jax_optimize):
        parser = argparse.ArgumentParser()
        package.cli(parser)
        parsers.append(parser)
    argv = ['--lr', '0.1', '--lr-decay', '10', '20', '--adam',
            '--no-nesterov', '--weight-decay', '1e-4',
            '--lr-warm-restarts', '5']
    assert vars(parsers[0].parse_args(argv)) == \
        vars(parsers[1].parse_args(argv))
    assert vars(parsers[0].parse_args([])) == vars(parsers[1].parse_args([]))
