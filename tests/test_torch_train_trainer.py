"""The port's Trainer against the JAX package's ``build_train_step``.

Both sides take the same narrow ShuffleNetV2K with the cocokp heads (the
flax variables, BatchNorm randomised from a numpy seed, bridged with
``convert_jax``), the same batch of the port's CocoKp pipeline (two 97 px
crops of a synthetic COCO set, augmentation off) and the same optimizer
flags, and take three steps. After each step the losses agree, and after
the third the parameters, the BatchNorm buffers and the EMA, under each
trainer option.

Tolerances (float32 convolutions in two frameworks, the JAX side at
float32 matmul precision; the learning rate is small enough that three
steps stay where the loss is smooth): the loss rtol 1e-4, the
per-component losses rtol 1e-3; the parameters, the BatchNorm buffers and
the EMA each within 10% of the largest element of the tensor's JAX update
plus 1e-3 of the largest update of its kind, and rtol 2e-6 (float32's
resolution). Over the whole model the two updates agree far more closely
than in single tensors: the gradient is not smooth (clamps, kinks), and a
tensor that barely moves differs by rounding noise. ``remat`` must equal
the plain step bit for bit. ``bf16`` must give the port's float32 losses
within 2e-3 of the total, BatchNorm statistics whose update differs by at
most 5% (L2), and backbone and head updates with a cosine above 0.8 to
the float32 ones (bf16 gradients of a random-init model are far from the
float32 ones element by element; their direction is what holds).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpifpaf_tpu.training import losses as jax_losses
from openpifpaf_tpu.training import optimize as jax_optimize
from openpifpaf_tpu.training.trainer import TrainState, build_train_step
from openpifpaf_tpu_torch.models import convert_jax
from openpifpaf_tpu_torch.models.shell import assign_strides
from openpifpaf_tpu_torch.plugins.coco.cocokp import CocoKp
from openpifpaf_tpu_torch.training import losses, optimize
from openpifpaf_tpu_torch.training.trainer import Trainer

from torch_port_helpers import jax_f32, jax_metas, jax_narrow_shell, \
    one_torch_thread, optimizer_args, port_metas, port_narrow_shell, \
    randomize_variables, write_synthetic_coco

LOSS_RTOL = 1e-4
HEAD_RTOL = 1e-3
UPDATE_RTOL = 0.1
UPDATE_FLOOR = 1e-3
BF16_RTOL = 2e-3
BF16_STATS_RTOL = 0.05
BF16_MIN_COSINE = 0.8
N_STEPS = 3
BATCH_SEED = 5
#: a warm-up over the three steps, so that the learning rate differs
#: between steps (the clip and the optimizer read it by their counters)
OPT = dict(lr=2e-6, lr_warm_up_epochs=3, lr_warm_up_factor=0.1)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    one_torch_thread()


@pytest.fixture(scope='module')
def batch(tmp_path_factory):
    """(images (2, 97, 97, 3), (cif, caf) targets) of the port's pipeline."""
    directory = tmp_path_factory.mktemp('coco')
    ann_file, image_dir = write_synthetic_coco(str(directory), n_images=4,
                                               image_hw=(97, 129), seed=3)
    datamodule = CocoKp(train_annotations=ann_file,
                        train_image_dir=image_dir, square_edge=97,
                        augmentation=False, batch_size=2)
    assign_strides(datamodule.head_metas, 16)
    np.random.seed(BATCH_SEED)  # CenterPad draws its fill colour
    images, targets, _ = next(iter(datamodule.train_loader()))
    assert np.isnan(targets[0]).any() and (targets[0][:, :, 0] == 1).any()
    return images, targets


@pytest.fixture(scope='module')
def jax_variables():
    model = jax_narrow_shell(jax_metas(16))
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, 65, 65, 3)), train=True)
    return jax.tree_util.tree_map(np.asarray,
                                  randomize_variables(variables, seed=11))


def jax_loss_fn(**factory_attrs):
    factory = jax_losses.Factory()
    for k, v in factory_attrs.items():
        setattr(factory, k, v)
    return factory.factory(jax_metas(16))


def port_loss_fn(**factory_attrs):
    factory = losses.Factory()
    for k, v in factory_attrs.items():
        setattr(factory, k, v)
    return factory.factory(port_metas(16))


def run_jax(variables, batch, *, opt=OPT, loss_attrs=None, n_steps=N_STEPS,
            **step_kwargs):
    """(per-step (loss, head losses), final TrainState) of the JAX step."""
    model = jax_narrow_shell(jax_metas(16))
    loss_fn = jax_loss_fn(**(loss_attrs or {}))
    optimizer, schedule = jax_optimize.factory_optimizer(
        optimizer_args(**opt), training_batches_per_epoch=1)
    params = variables['params']
    loss_params = loss_fn.init_params()
    stride_apply = step_kwargs.get('stride_apply', 1)
    state = TrainState(
        params=params,
        batch_stats=variables['batch_stats'],
        opt_state=optimizer.init({'model': params, 'loss': loss_params}),
        ema_params=jax.tree_util.tree_map(jnp.copy, params),
        step=jnp.zeros((), dtype=jnp.int32),
        loss_params=loss_params,
        loss_state=loss_fn.init_state(),
        grad_accum=(jax.tree_util.tree_map(
            jnp.zeros_like, {'model': params, 'loss': loss_params})
            if stride_apply > 1 else {}),
    )
    step = build_train_step(
        model, loss_fn, optimizer, schedule,
        task_sparsity_weight=loss_fn.task_sparsity_weight, **step_kwargs)
    images, targets = batch
    history = []
    with jax_f32():
        for _ in range(n_steps):
            state, loss, head_losses = step(
                state, jnp.asarray(images),
                tuple(jnp.asarray(t) for t in targets))
            history.append((float(loss), [float(l) for l in head_losses]))
    return history, state


def port_trainer(variables, *, opt=OPT, loss_attrs=None, **trainer_attrs):
    model = port_narrow_shell(port_metas(16))
    convert_jax.load_jax_variables(model, variables)
    optimizer, schedule = optimize.factory_optimizer(
        optimizer_args(**opt), training_batches_per_epoch=1)
    trainer = Trainer(model, port_loss_fn(**(loss_attrs or {})), optimizer,
                      schedule, 'unused', device='cpu')
    for k, v in trainer_attrs.items():
        setattr(trainer, k, v)
    return trainer


def run_port(trainer, batch, *, fix_bn=False, n_steps=N_STEPS):
    images, targets = batch
    images = torch.from_numpy(images)
    targets = tuple(torch.from_numpy(t) for t in targets)
    history = []
    for _ in range(n_steps):
        loss, head_losses = trainer.train_step(images, targets,
                                               fix_bn=fix_bn)
        history.append((float(loss), [float(l) for l in head_losses]))
    return history


def assert_updates_close(ours, ref, start):
    """Tensors (dicts by name) after the steps from ``start``: equal
    within 10% of the largest element of the tensor's JAX update, plus
    1e-3 of the largest update of any tensor (a tensor that barely moves,
    such as a BatchNorm bias that the next BatchNorm cancels, moves by
    rounding noise), and within float32's resolution (rtol 2e-6)."""
    floor = max(float(np.abs(ref[n] - start[n]).max()) for n in ref)
    for name in ref:
        update = float(np.abs(ref[name] - start[name]).max())
        np.testing.assert_allclose(
            ours[name], ref[name], rtol=2e-6,
            atol=UPDATE_RTOL * update + UPDATE_FLOOR * floor, err_msg=name)


def assert_state_close(trainer, state, start):
    """Parameters, BatchNorm buffers and the EMA against the JAX state."""
    ref = convert_jax.state_dict_from_jax(
        {'params': state.params, 'batch_stats': state.batch_stats})
    ref_ema = convert_jax.state_dict_from_jax(
        {'params': state.ema_params, 'batch_stats': state.batch_stats})
    ours = trainer.model.state_dict()
    assert set(ours) == set(ref) == set(start)
    params = [n for n, _ in trainer.model.named_parameters()]
    buffers = [n for n in ours if n not in params
               and not n.endswith('num_batches_tracked')]
    ema = dict(zip(params, trainer.ema))
    for names, mine, theirs in ((params, ours, ref), (buffers, ours, ref),
                                (params, ema, ref_ema)):
        assert_updates_close({n: mine[n].numpy() for n in names},
                             {n: theirs[n].numpy() for n in names},
                             {n: start[n].numpy() for n in names})


def assert_history_close(ours, ref):
    assert len(ours) == len(ref)
    for (loss, heads), (ref_loss, ref_heads) in zip(ours, ref):
        assert np.isfinite(loss)
        np.testing.assert_allclose(loss, ref_loss, rtol=LOSS_RTOL)
        np.testing.assert_allclose(heads, ref_heads, rtol=HEAD_RTOL)


CASES = {
    'plain': {},
    'clip_grad_norm': {'clip_grad_norm': 1e-5},
    'clip_grad_value_cross_talk': {'clip_grad_value': 1.0,
                                   'cross_talk': 0.3},
    'stride_apply': {'stride_apply': 2},
    'fix_bn': {'fix_bn': True},
    'task_sparsity_weight': {'loss': {'task_sparsity_weight': 0.5}},
    'kendall': {'loss': {'auto_tune_mtl': True}, 'clip_grad_norm': 1e-5,
                'stride_apply': 2},
    'variance_weight_decay_no_nesterov': {
        'loss': {'auto_tune_mtl_variance': True},
        'opt': dict(OPT, nesterov=False, weight_decay=1e-2)},
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_three_steps_match_jax(case, batch, jax_variables):
    kw = dict(CASES[case])
    loss_attrs = kw.pop('loss', None)
    opt = kw.pop('opt', OPT)
    fix_bn = kw.get('fix_bn', False)
    ref, state = run_jax(jax_variables, batch, opt=opt,
                         loss_attrs=loss_attrs, **kw)
    trainer_attrs = {k: v for k, v in kw.items() if k != 'fix_bn'}
    trainer = port_trainer(jax_variables, opt=opt, loss_attrs=loss_attrs,
                           **trainer_attrs)
    ours = run_port(trainer, batch, fix_bn=fix_bn)
    assert_history_close(ours, ref)
    assert trainer.step == int(state.step) == N_STEPS
    assert_state_close(trainer, state,
                       convert_jax.state_dict_from_jax(jax_variables))
    if loss_attrs and loss_attrs.get('auto_tune_mtl'):
        assert_updates_close(
            {'s': trainer.loss_params['log_sigmas'].detach().numpy()},
            {'s': np.asarray(state.loss_params['log_sigmas'])}, {'s': 0.0})
    if loss_attrs and loss_attrs.get('auto_tune_mtl_variance'):
        np.testing.assert_allclose(trainer.loss_state['buffer'].numpy(),
                                   np.asarray(state.loss_state['buffer']),
                                   rtol=HEAD_RTOL)
        assert int(trainer.loss_state['index']) == \
            int(state.loss_state['index'])


def test_stride_apply_steps_the_schedule_on_applied_updates(batch,
                                                            jax_variables):
    """With --stride-apply 2 the optimizer's learning rate advances once
    per applied update (optax's count), the trainer's counter on every
    step, and the EMA only on applied steps."""
    trainer = port_trainer(jax_variables, stride_apply=2)
    ema0 = [e.clone() for e in trainer.ema]
    lrs = [trainer.optimizer.param_groups[0]['lr']]
    for i in range(4):
        run_port(trainer, batch, n_steps=1)
        lrs.append(trainer.optimizer.param_groups[0]['lr'])
        if i == 0:
            assert all(torch.equal(a, b) for a, b in zip(trainer.ema, ema0))
    schedule = optimize.schedule_from_args(optimizer_args(**OPT), 1)
    np.testing.assert_allclose(
        lrs, [schedule(0), schedule(0), schedule(1), schedule(1),
              schedule(2)], rtol=1e-12)
    assert trainer.step == 4


def test_remat_equals_plain_step(batch, jax_variables):
    plain = port_trainer(jax_variables)
    remat = port_trainer(jax_variables, remat=True)
    assert run_port(remat, batch) == run_port(plain, batch)
    for a, b in zip(remat.model.state_dict().values(),
                    plain.model.state_dict().values()):
        assert torch.equal(a, b)


def _update(model, start, names):
    return torch.cat([(p.detach() - start[n]).flatten()
                      for n, p in model.named_parameters() if n in names])


def test_bf16_step_near_float32_step(batch, jax_variables):
    """One bf16 step against the port's float32 step: the same losses to
    bf16's precision, the same BatchNorm statistics and an update in the
    same direction; master weights and buffers stay float32."""
    f32 = port_trainer(jax_variables)
    bf16 = port_trainer(jax_variables, bf16=True)
    start = {k: v.clone() for k, v in f32.model.state_dict().items()}
    (loss, heads), = run_port(bf16, batch, n_steps=1)
    (ref_loss, ref_heads), = run_port(f32, batch, n_steps=1)
    np.testing.assert_allclose(loss, ref_loss, rtol=BF16_RTOL)
    # a component sums terms of both signs (the logb weighting), so its
    # error is held against the total
    np.testing.assert_allclose(heads, ref_heads, rtol=0,
                               atol=BF16_RTOL * ref_loss)
    for name, value in bf16.model.state_dict().items():
        assert value.dtype == start[name].dtype, name
        if 'running_' in name:
            reference = f32.model.state_dict()[name]
            assert float((value - reference).norm()) <= BF16_STATS_RTOL * \
                float((reference - start[name]).norm()), name
    names = dict(f32.model.named_parameters())
    for part in ('base_net.', 'head_nets.'):
        subset = [n for n in names if n.startswith(part)]
        ours = _update(bf16.model, start, subset)
        ref = _update(f32.model, start, subset)
        cosine = float(ours @ ref / ours.norm() / ref.norm())
        assert cosine > BF16_MIN_COSINE, (part, cosine)


def test_val_step_leaves_state_unchanged(batch, jax_variables):
    trainer = port_trainer(jax_variables, loss_attrs={
        'auto_tune_mtl_variance': True})
    before = copy.deepcopy(trainer.model.state_dict())
    loss_state = {k: v.clone() for k, v in trainer.loss_state.items()}
    images, targets = batch
    loss, head_losses = trainer.val_step(
        torch.from_numpy(images), tuple(torch.from_numpy(t) for t in targets))
    assert np.isfinite(float(loss)) and len(head_losses) == 6
    for name, value in trainer.model.state_dict().items():
        assert torch.equal(value, before[name]), name
    for k, v in loss_state.items():
        np.testing.assert_array_equal(trainer.loss_state[k].numpy(),
                                      v.numpy())
    assert trainer.step == 0
    assert all(p.grad is None for p in trainer.params)


def test_non_finite_loss_raises(batch, jax_variables, tmp_path):
    trainer = port_trainer(jax_variables)
    images, targets = batch
    bad = images.copy()
    bad[0, 0, 0, 0] = np.inf
    metas = [{'head_indices': [0, 1]}] * 2
    with pytest.raises(ValueError, match='non-finite loss'):
        trainer.train([(bad, list(targets), metas)], epoch=0)


def test_head_dropout_rate_scale_and_seeded_generator(monkeypatch):
    """``--cf4-dropout p``: in train mode each feature is kept with
    probability 1 - p (within 10 binomial standard deviations over 2e5
    draws) and scaled by 1 / (1 - p); a generator with the same seed
    draws the same mask; eval mode drops nothing. (JAX's stream,
    ``fold_in(PRNGKey(4242), step)``, cannot be matched bit for bit.)"""
    from openpifpaf_tpu_torch.models import factory as models_factory
    from openpifpaf_tpu_torch.models.heads import dropout

    p, n = 0.3, 200_000
    x = torch.ones(n)
    y = dropout(x, p, torch.Generator().manual_seed(3))
    kept = y != 0
    assert abs(float(kept.float().mean()) - (1 - p)) < \
        10 * np.sqrt(p * (1 - p) / n)
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / (1 - p)))
    assert torch.equal(y, dropout(x, p, torch.Generator().manual_seed(3)))
    assert not torch.equal(y, dropout(x, p, torch.Generator().manual_seed(4)))

    monkeypatch.setitem(models_factory.CF4_OPTIONS, 'dropout_p', p)
    model = port_narrow_shell(port_metas(16))
    assert [hn.dropout_p for hn in model.head_nets] == [p, p]
    image = torch.from_numpy(
        np.random.RandomState(0).randn(1, 33, 33, 3).astype(np.float32))
    with torch.no_grad():
        runs = [model(image, train=True,
                      generator=torch.Generator().manual_seed(seed))
                for seed in (5, 5, 6)]
        assert torch.equal(runs[0][0], runs[1][0])
        assert not torch.equal(runs[0][0], runs[2][0])
        model.head_nets[0].dropout_p = 0.0
        plain = model(image, train=True)
        assert not torch.equal(plain[0], runs[0][0])
        model.head_nets[0].dropout_p = p
        assert torch.equal(model(image)[0], model(image)[0])
