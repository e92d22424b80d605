"""The port's losses against the JAX package's: values and gradients.

Random raw head outputs and targets with NaN holes (crowd cells, cells
without a regression target) go through each loss component, the
per-head ``CompositeLoss`` and the multi-head losses (plain, Kendall and
Variance); values (rtol 1e-5, atol 1e-6) and gradients (``torch.autograd``
against ``jax.grad``; rtol 1e-4, atol 1e-5) must agree: float32 sums in
another order, and exp, tanh and log1p of two libraries, whose gradients
differ in the last digits of single elements.
The soft clamp's gradient must stay finite at the pole of its untaken
branch, as the JAX test requires.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpifpaf_tpu.training import losses as jax_losses
from openpifpaf_tpu_torch.training import losses

from torch_port_helpers import jax_metas, port_metas

RTOL = 1e-5
ATOL = 1e-6
GRAD_RTOL = 1e-4
GRAD_ATOL = 1e-5


def _fields(n_fields, n_x, n_t, seed, hw=(9, 11), batch=2):
    """(x (B, F, n_x, H, W), t (B, F, n_t, H, W)): logits around the
    clamps, confidences 1/0/NaN, regressions and scales only where the
    confidence is 1, some of those scales NaN."""
    rng = np.random.RandomState(seed)
    shape = (batch, n_fields)
    x = (rng.randn(*shape, n_x, *hw) * 3.0).astype(np.float32)
    conf = rng.choice([1.0, 0.0, np.nan], size=(*shape, *hw),
                      p=[0.3, 0.6, 0.1]).astype(np.float32)
    t = np.full((*shape, n_t, *hw), np.nan, dtype=np.float32)
    t[:, :, 0] = conf
    fg = conf == 1.0
    for c in range(1, n_t):
        values = rng.uniform(0.5, 4.0, (*shape, *hw)).astype(np.float32)
        t[:, :, c] = np.where(fg, values, np.nan)
    # some foreground cells without a scale target
    t[:, :, -1][fg & (rng.rand(*shape, *hw) < 0.2)] = np.nan
    return x, t


def _cif_fields(seed):
    return _fields(17, 5, 5, seed)


def _caf_fields(seed):
    return _fields(19, 8, 9, seed)


def _compare(jax_fn, torch_fn, *arrays, argnums=(0,)):
    """Value and gradients with respect to ``argnums`` of a scalar
    function in both frameworks."""
    ref, ref_grads = jax.value_and_grad(jax_fn, argnums=argnums)(
        *(jnp.asarray(a) for a in arrays))
    tensors = [torch.tensor(a, requires_grad=i in argnums)
               for i, a in enumerate(arrays)]
    out = torch_fn(*tensors)
    grads = torch.autograd.grad(out, [tensors[i] for i in argnums])
    out = float(out.detach())
    np.testing.assert_allclose(out, float(ref), rtol=RTOL, atol=ATOL)
    for g, r in zip(grads, ref_grads):
        assert np.all(np.isfinite(g.numpy()))
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
    return out


def _channel_last(x):
    return np.moveaxis(x, 2, -1)


BCE_OPTIONS = [
    {},
    {'focal_gamma': 2.0},
    {'focal_gamma': 0.0, 'focal_alpha': 0.0},
    {'soft_clamp_value': 0.0, 'background_clamp': None},
]


@pytest.mark.parametrize('options', BCE_OPTIONS)
def test_bce_loss(options):
    x, t = _cif_fields(0)
    x, t = _channel_last(x), _channel_last(t)
    value = _compare(
        lambda a, b: jax_losses.bce_loss(a, b, xi=[1], ti=[0], **options),
        lambda a, b: losses.bce_loss(a, b, xi=[1], ti=[0], **options), x, t)
    assert value != 0.0


@pytest.mark.parametrize('options', [
    {}, {'soft_clamp_value': 0.0}, {'sigma_from_scale': 0.1}])
def test_regression_loss(options):
    x, t = _caf_fields(1)
    x, t = _channel_last(x), _channel_last(t)
    _compare(
        lambda a, b: jax_losses.regression_loss(
            a, b, xi=[2, 3, 6], ti=[1, 2, 5, 7], **options),
        lambda a, b: losses.regression_loss(
            a, b, xi=[2, 3, 6], ti=[1, 2, 5, 7], **options), x, t)


def test_regression_loss_scale_from_wh_at_zero():
    """The detection form takes sqrt(w^2 + h^2 + 1e-12); w = h = 0 keeps
    a finite gradient."""
    x, t = _fields(3, 6, 7, seed=2)
    x, t = _channel_last(x), _channel_last(t)
    x[..., 4:6] = 0.0
    t[..., 3:5] = np.where(np.isfinite(t[..., 3:5]), 0.0, t[..., 3:5])
    _compare(
        lambda a, b: jax_losses.regression_loss(
            a, b, xi=[2, 3, 4, 5], ti=[1, 2, 5, 3, 4], sigma_from_scale=0.1,
            scale_from_wh=True),
        lambda a, b: losses.regression_loss(
            a, b, xi=[2, 3, 4, 5], ti=[1, 2, 5, 3, 4], sigma_from_scale=0.1,
            scale_from_wh=True), x, t)


@pytest.mark.parametrize('options', [
    {}, {'log_space': True}, {'b': 0.5, 'soft_clamp_value': 0.0}])
def test_scale_loss(options):
    x, t = _cif_fields(3)
    x, t = _channel_last(x), _channel_last(t)
    _compare(
        lambda a, b: jax_losses.scale_loss(a, b, xi=[4], ti=[4], **options),
        lambda a, b: losses.scale_loss(a, b, xi=[4], ti=[4], **options),
        x, t)


def test_soft_clamp_and_smooth_l1_values_and_gradients():
    x = np.linspace(-8.0, 12.0, 81).astype(np.float32)
    _compare(lambda a: jnp.sum(jax_losses.soft_clamp(a, 5.0) ** 2),
             lambda a: torch.sum(losses.soft_clamp(a, 5.0) ** 2), x)
    _compare(lambda a: jnp.sum(jax_losses.smooth_l1(a) * a),
             lambda a: torch.sum(losses.smooth_l1(a) * a), x)


def test_soft_clamp_gradient_finite_at_pole():
    """d/dx of the untaken log1p branch has a pole at x = max_value - 1;
    ``torch.where`` does not keep it out of the backward pass, so the
    argument's pre-clamp must keep the gradient finite everywhere."""
    for value in (4.0, 5.0, 6.0, 3.0, 0.0, -2.0, -100.0):
        x = torch.tensor(value, requires_grad=True)
        y = losses.soft_clamp(x, 5.0)
        (grad,) = torch.autograd.grad(y, x)
        ref = jax.grad(lambda v: jax_losses.soft_clamp(v, 5.0))(
            jnp.float32(value))
        assert np.isfinite(float(grad)) and np.isfinite(float(y))
        assert float(grad) == pytest.approx(float(ref), rel=1e-6)
    assert float(losses.soft_clamp(torch.tensor(10.0), 5.0)) == \
        pytest.approx(5.0 + np.log1p(5.0))


@pytest.fixture
def component_config():
    """Both packages' component settings, restored afterwards."""
    saved = (dataclasses.replace(losses.COMPONENT_CONFIG),
             dataclasses.replace(jax_losses.COMPONENT_CONFIG))
    yield
    for target, value in zip((losses.COMPONENT_CONFIG,
                              jax_losses.COMPONENT_CONFIG), saved):
        for f in dataclasses.fields(value):
            setattr(target, f.name, getattr(value, f.name))


@pytest.mark.parametrize('settings', [
    {}, {'focal_gamma': 2.0, 'scale_log': True, 'b_scale': 2.0},
    {'bce_soft_clamp': 3.0, 'regression_soft_clamp': 2.0,
     'scale_soft_clamp': 1.0, 'bce_background_clamp': -5.0}])
@pytest.mark.parametrize('head', [0, 1])
def test_composite_loss_components(component_config, settings, head):
    for config in (losses.COMPONENT_CONFIG, jax_losses.COMPONENT_CONFIG):
        for k, v in settings.items():
            setattr(config, k, v)
    jax_loss = jax_losses.CompositeLoss(jax_metas(16)[head])
    port_loss = losses.CompositeLoss(port_metas(16)[head])
    assert port_loss.field_names == jax_loss.field_names
    x, t = (_cif_fields, _caf_fields)[head](4 + head)
    for name in port_loss.field_names:
        _compare(lambda a, b: jax_loss(a, b)[name],
                 lambda a, b: port_loss(a, b)[name], x, t)


def test_composite_loss_training_weights():
    jax_meta, port_meta = jax_metas(16)[0], port_metas(16)[0]
    weights = np.random.RandomState(5).uniform(0.5, 2.0, 17).tolist()
    jax_meta.training_weights = port_meta.training_weights = weights
    x, t = _cif_fields(6)
    for name in losses.CompositeLoss(port_meta).field_names:
        _compare(lambda a, b: jax_losses.CompositeLoss(jax_meta)(a, b)[name],
                 lambda a, b: losses.CompositeLoss(port_meta)(a, b)[name],
                 x, t)


def _factory(package, **attrs):
    factory = package.Factory()
    for k, v in attrs.items():
        setattr(factory, k, v)
    metas = jax_metas(16) if package is jax_losses else port_metas(16)
    return factory.factory(metas)


MULTI_HEAD = [
    ('plain', {}),
    ('lambdas', {'lambdas': [1.0, 2.5]}),
    ('component_lambdas', {'component_lambdas': [1, 2, 3, 0.5, 1, 0]}),
    ('kendall', {'auto_tune_mtl': True}),
]


@pytest.mark.parametrize('name,attrs', MULTI_HEAD, ids=[m[0] for m in MULTI_HEAD])
def test_multi_head_loss(name, attrs):
    jax_loss, port_loss = _factory(jax_losses, **attrs), \
        _factory(losses, **attrs)
    assert type(port_loss).__name__ == type(jax_loss).__name__
    assert port_loss.field_names == jax_loss.field_names
    assert port_loss.lambdas == jax_loss.lambdas
    cif_x, cif_t = _cif_fields(7)
    caf_x, caf_t = _caf_fields(8)
    sigmas = np.random.RandomState(9).uniform(-2.0, 2.0, 6).astype(np.float32)

    def jax_total(a, b, s):
        params = {'log_sigmas': s} if name == 'kendall' else {}
        return jax_loss((a, b), (jnp.asarray(cif_t), jnp.asarray(caf_t)),
                        params, {})[0]

    def port_total(a, b, s):
        params = {'log_sigmas': s} if name == 'kendall' else {}
        return port_loss((a, b), (torch.from_numpy(cif_t),
                                  torch.from_numpy(caf_t)), params, {})[0]

    _compare(jax_total, port_total, cif_x, caf_x, sigmas,
             argnums=(0, 1, 2) if name == 'kendall' else (0, 1))


def test_multi_head_loss_skips_heads_without_targets():
    jax_loss, port_loss = _factory(jax_losses), _factory(losses)
    cif_x, cif_t = _cif_fields(10)
    _, ref, _ = jax_loss((jnp.asarray(cif_x), None),
                         (jnp.asarray(cif_t), None), {}, {})
    total, flat, _ = port_loss((torch.from_numpy(cif_x), None),
                               (torch.from_numpy(cif_t), None), {}, {})
    assert flat[3:] == ref[3:] == [None] * 3
    np.testing.assert_allclose([float(v) for v in flat[:3]],
                               [float(v) for v in ref[:3]], rtol=RTOL)
    assert float(total) == pytest.approx(sum(float(v) for v in ref[:3]),
                                         rel=RTOL)


def test_variance_loss_over_steps():
    """The running buffer and the normalised total over 4 calls (the
    index wraps at 53; NaN entries before the buffer fills)."""
    jax_loss = _factory(jax_losses, auto_tune_mtl_variance=True)
    port_loss = _factory(losses, auto_tune_mtl_variance=True)
    jax_state, port_state = jax_loss.init_state(), port_loss.init_state()
    for step in range(4):
        cif_x, cif_t = _cif_fields(20 + step)
        caf_x, caf_t = _caf_fields(30 + step)
        ref_total, ref_grads = jax.value_and_grad(
            lambda a, b: jax_loss((a, b), (jnp.asarray(cif_t),
                                           jnp.asarray(caf_t)),
                                  {}, jax_state)[0],
            argnums=(0, 1))(jnp.asarray(cif_x), jnp.asarray(caf_x))
        _, _, jax_state = jax_loss(
            (jnp.asarray(cif_x), jnp.asarray(caf_x)),
            (jnp.asarray(cif_t), jnp.asarray(caf_t)), {}, jax_state)
        xs = [torch.tensor(cif_x, requires_grad=True),
              torch.tensor(caf_x, requires_grad=True)]
        total, _, port_state = port_loss(
            xs, (torch.from_numpy(cif_t), torch.from_numpy(caf_t)), {},
            port_state)
        grads = torch.autograd.grad(total, xs)
        np.testing.assert_allclose(float(total), float(ref_total),
                                   rtol=RTOL)
        for g, r in zip(grads, ref_grads):
            np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL)
        np.testing.assert_allclose(port_state['buffer'].numpy(),
                                   np.asarray(jax_state['buffer']),
                                   rtol=RTOL)
        assert int(port_state['index']) == int(jax_state['index']) == step


def test_loss_flags_match_jax():
    import argparse
    parsers = []
    for package in (losses, jax_losses):
        parser = argparse.ArgumentParser()
        package.Factory.cli(parser)
        parsers.append(parser)
    argv = ['--lambdas', '1', '2', '--auto-tune-mtl', '--focal-gamma', '2',
            '--scale-log', '--task-sparsity-weight', '0.1']
    assert vars(parsers[0].parse_args(argv)) == \
        vars(parsers[1].parse_args(argv))
