"""Multi-dataset training of the PyTorch port against the JAX package:
``MultiLoader``, ``MultiDataModule``, the factory's ``a-b`` names, the
train CLI's ``--dataset-weights``, mixed steps with absent heads, and the
reference's tracking mix ``cocokpst-posetrack2018``.

Tolerances:
- the loader order, the target expansion and the batches of the mix (from
  the same seeded global ``np.random``) are equal, bit for bit;
- three steps of a narrow ShuffleNetV2K with the cocokp and cocodet heads
  on the mix's batches (cocokp, cocodet, cocokp at ``--dataset-weights 2
  1``): the losses and each component as ``test_torch_train_trainer.py``
  holds them (rtol 1e-4 and 1e-3), ``None`` where JAX has ``None``, then
  the parameters, BatchNorm buffers and EMA within that file's update
  tolerance (10% of each tensor's JAX update plus 1e-3 of the largest).
  The parity is held at the step the two train CLIs run; the port's CLI
  then trains the full-width mix on the CPU and writes a 3-head
  checkpoint that ``Predictor`` decodes through ``Multi``.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openpifpaf_tpu
from openpifpaf_tpu.datasets.multiloader import MultiLoader as JaxMultiLoader
from openpifpaf_tpu.models.shell import assign_strides as jax_assign_strides
from openpifpaf_tpu.plugins.coco.cocodet import CocoDet as JaxCocoDet
from openpifpaf_tpu.plugins.coco.cocokp import CocoKp as JaxCocoKp
from openpifpaf_tpu.plugins.posetrack.posetrack2018 import \
    Posetrack2018 as JaxPosetrack2018
from openpifpaf_tpu.training import losses as jax_losses
from openpifpaf_tpu.training import optimize as jax_optimize
from openpifpaf_tpu.training.trainer import TrainState, build_train_step
from openpifpaf_tpu_torch import datasets
from openpifpaf_tpu_torch.datasets import MultiDataModule, MultiLoader
from openpifpaf_tpu_torch.models import convert_jax
from openpifpaf_tpu_torch.models.shell import assign_strides
from openpifpaf_tpu_torch.plugins.coco.cocodet import CocoDet
from openpifpaf_tpu_torch.plugins.coco.cocokp import CocoKp
from openpifpaf_tpu_torch.plugins.posetrack.posetrack2018 import \
    Posetrack2018
from openpifpaf_tpu_torch.predictor import Predictor
from openpifpaf_tpu_torch.training import losses, optimize
from openpifpaf_tpu_torch.training.trainer import Trainer

from test_torch_train_trainer import HEAD_RTOL, LOSS_RTOL, \
    assert_state_close, assert_updates_close
from torch_port_helpers import jax_f32, jax_narrow_shell, \
    jax_narrow_tracking_shell, numpy_variables, one_torch_thread, \
    optimizer_args, port_narrow_shell, restored_statics, write_synthetic_coco, write_synthetic_cocodet, \
    write_synthetic_posetrack2018

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 4
EDGE = 97
STRIDE = 16
WEIGHTS = [2.0, 1.0]
#: momentum and weight decay act on a head absent from a step (a decay
#: large enough to move it beyond float32's resolution at this rate)
OPT = dict(lr=2e-6, lr_warm_up_epochs=3, lr_warm_up_factor=0.1,
           weight_decay=1e2)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    one_torch_thread()


@pytest.fixture(scope='module')
def data(tmp_path_factory):
    """(cocokp set of 4 images, cocodet set of 2) of 97x129; the cocodet
    set carries 17 absent keypoints, which the JAX pipelines need."""
    directory = tmp_path_factory.mktemp('mix')
    coco = write_synthetic_coco(str(directory / 'coco'), n_images=4,
                                image_hw=(97, 129), seed=3)
    det = write_synthetic_cocodet(str(directory / 'det'), n_images=2,
                                  image_hw=(97, 129), seed=4,
                                  keypoints=True)
    return coco, det


# -- MultiLoader -------------------------------------------------------------

class _FakeLoader:
    """``n`` batches whose metas name ``head_indices``; ``short`` batches
    fewer than ``len`` says, as a loader that runs dry early."""

    def __init__(self, name, n, head_indices, short=0):
        self.name = name
        self.n = n
        self.head_indices = head_indices
        self.short = short
        self.epochs = []

    def set_epoch(self, epoch):
        self.epochs.append(epoch)

    def __len__(self):
        return self.n

    def __iter__(self):
        for i in range(self.n - self.short):
            targets = [f'{self.name}{i}.{h}' for h in self.head_indices]
            yield (f'{self.name}{i}', targets,
                   [{'head_indices': self.head_indices}])


def _fake_loaders():
    return [_FakeLoader('kp', 5, [0, 1]), _FakeLoader('det', 3, [2]),
            _FakeLoader('wb', 4, [3, 4], short=2)]


@pytest.mark.parametrize('weights', [None, [2, 1, 1], [1, 3, 1]])
def test_multiloader_order_and_targets_equal_jax(weights):
    """The weighted pick (max of remaining / total / weight, the first
    index winning a tie), a loader that runs dry (its remaining set to 0)
    and the targets placed by ``head_indices``."""
    ours = list(MultiLoader(_fake_loaders(), 5, weights=weights))
    ref = list(JaxMultiLoader(_fake_loaders(), 5, weights=weights))
    assert ours == ref
    assert len(ours) == 5 + 3 + 2
    for images, targets, _ in ours:
        name = images.rstrip('0123456789')
        slots = {'kp': [0, 1], 'det': [2], 'wb': [3, 4]}[name]
        assert [i for i, t in enumerate(targets) if t is not None] == slots
    full = [_FakeLoader('kp', 5, [0, 1]), _FakeLoader('det', 3, [2])]
    loader = MultiLoader(full, 3, weights=weights and weights[:2])
    assert [['kp', 'det'].index(b[0].rstrip('0123456789'))
             for b in loader] == loader.order()


def test_multiloader_zero_weight_is_never_picked():
    """Share 0 for a loader of weight 0; the epoch ends when the others
    are done (JAX's loop would pick the first, exhausted loader forever
    from then on: ROADMAP §C)."""
    loader = MultiLoader(_fake_loaders(), 5, weights=[1, 3, 0])
    names = [b[0].rstrip('0123456789') for b in loader]
    assert sorted(names) == ['det'] * 3 + ['kp'] * 5
    assert loader.order() == [['kp', 'det'].index(n) for n in names]


def test_multiloader_passes_set_epoch_on():
    loaders = _fake_loaders()
    MultiLoader(loaders, 5).set_epoch(3)
    assert [l.epochs for l in loaders] == [[3], [3], [3]]


# -- MultiDataModule and the factory ----------------------------------------

def test_multidatamodule_equals_jax(data):
    """``cocokp-cocodet`` in order: the heads concatenated, the metrics
    concatenated, ``eval_loader`` refused, ``weights`` a class attribute;
    a name that is not registered raises in both."""
    with restored_statics(*PORT[:2], PORT[3], *JAX[:2], JAX[3]):
        ours = _mix(PORT, data)
        ref = _mix(JAX, data)
        metrics = [type(m).__name__ for m in ours.metrics()]
        ref_metrics = [type(m).__name__ for m in ref.metrics()]
        assert ours.weights == ref.weights == WEIGHTS
    assert metrics == ref_metrics == ['Coco', 'Coco']
    assert isinstance(ours, MultiDataModule)
    assert [(type(m).__name__, m.dataset, m.name) for m in ours.head_metas] \
        == [(type(m).__name__, m.dataset, m.name) for m in ref.head_metas] \
        == [('Cif', 'cocokp', 'cif'), ('Caf', 'cocokp', 'caf'),
            ('CifDet', 'cocodet', 'cifdet')]
    assert [type(dm).__name__ for dm in ours.datamodules] == \
        ['CocoKp', 'CocoDet']
    assert ours.head_metas[2] is ours.datamodules[1].head_metas[0]
    assert list(datasets.ConcatenatedLists([[1, 2], [3]])) == [1, 2, 3]
    assert datasets.ConcatenatedLists([[1, 2], [3]])[2] == 3
    assert 'weights' in vars(MultiDataModule) and MultiDataModule.weights \
        is None
    with pytest.raises(NotImplementedError):
        ours.eval_loader()
    with pytest.raises(NotImplementedError):
        ref.eval_loader()
    for factory in (datasets.factory, openpifpaf_tpu.datasets.factory):
        with pytest.raises(ValueError, match='unknown'):
            factory('cocokp-nosuchset')


def test_batch_size_reaches_every_dataset():
    """The train CLI sets ``batch_size`` and ``loader_workers`` on the
    data module; on a mix they reach each dataset (JAX keeps them on the
    mix object, so its datasets load batches of 1: ROADMAP §C)."""
    ours = datasets.factory('cocokp-cocodet')
    ours.batch_size = 4
    ours.loader_workers = 2
    assert [(dm.batch_size, dm.loader_workers) for dm in ours.datamodules] \
        == [(4, 2), (4, 2)]
    ref = openpifpaf_tpu.datasets.factory('cocokp-cocodet')
    ref.batch_size = 4
    assert [dm.batch_size for dm in ref.datamodules] == [1, 1]


def _mix(package, data):
    """The ``cocokp-cocodet`` module of ``package`` on ``data`` at 97 px,
    batch 2, ``--dataset-weights 2 1``, its heads' strides assigned."""
    kp_cls, det_cls, factory, multi_cls, assign = package
    (kp_ann, kp_dir), (det_ann, det_dir) = data
    kp_cls.train_annotations = kp_cls.val_annotations = \
        kp_cls.eval_annotations = kp_ann
    kp_cls.train_image_dir = kp_cls.val_image_dir = kp_dir
    det_cls.train_annotations = det_cls.val_annotations = \
        det_cls.eval_annotations = det_ann
    det_cls.train_image_dir = det_cls.val_image_dir = det_dir
    kp_cls.square_edge = det_cls.square_edge = EDGE
    multi_cls.weights = WEIGHTS
    datamodule = factory('cocokp-cocodet')
    for dm in datamodule.datamodules:
        dm.batch_size = 2
    assign(datamodule.head_metas, STRIDE)
    return datamodule


PORT = (CocoKp, CocoDet, datasets.factory, MultiDataModule, assign_strides)
JAX = (JaxCocoKp, JaxCocoDet, openpifpaf_tpu.datasets.factory,
       openpifpaf_tpu.datasets.MultiDataModule, jax_assign_strides)


def _batches(package, data):
    with restored_statics(*package[:2], package[3]):
        loader = _mix(package, data).train_loader()
        np.random.seed(SEED)
        return [(images, targets, metas[0]['head_indices'])
                for images, targets, metas in loader]


@pytest.fixture(scope='module')
def mixed_batches(data):
    ours = _batches(PORT, data)
    ref = _batches(JAX, data)
    return ours, ref


def test_mixed_batches_equal_jax(mixed_batches):
    """Two cocokp batches and one cocodet batch at weights 2 1: cocokp,
    cocodet, cocokp; the targets in the three global head slots."""
    ours, ref = mixed_batches
    assert [b[2] for b in ours] == [b[2] for b in ref] == \
        [[0, 1], [2], [0, 1]]
    for (images, targets, _), (r_images, r_targets, _) in zip(ours, ref):
        np.testing.assert_array_equal(images, r_images)
        assert [t is None for t in targets] == [t is None for t in r_targets]
        for t, r in zip(targets, r_targets):
            if t is not None:
                np.testing.assert_array_equal(t, r)


# -- mixed steps ---------------------------------------------------------------

@pytest.fixture(scope='module')
def jax_variables():
    metas = openpifpaf_tpu.datasets.factory('cocokp-cocodet').head_metas
    model = jax_narrow_shell(metas)
    return numpy_variables(jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 65, 65, 3)),
                           train=True)), seed=13)


def _loss_factory(factory_cls, metas, loss_attrs):
    factory = factory_cls()
    for k, v in loss_attrs.items():
        setattr(factory, k, v)
    return factory.factory(metas)


def _run_jax(variables, batches, loss_attrs):
    metas = openpifpaf_tpu.datasets.factory('cocokp-cocodet').head_metas
    model = jax_narrow_shell(metas)
    loss_fn = _loss_factory(jax_losses.Factory, metas, loss_attrs)
    optimizer, schedule = jax_optimize.factory_optimizer(
        optimizer_args(**OPT), training_batches_per_epoch=1)
    params = variables['params']
    loss_params = loss_fn.init_params()
    state = TrainState(
        params=params, batch_stats=variables['batch_stats'],
        opt_state=optimizer.init({'model': params, 'loss': loss_params}),
        ema_params=jax.tree_util.tree_map(jnp.copy, params),
        step=jnp.zeros((), dtype=jnp.int32), loss_params=loss_params,
        loss_state=loss_fn.init_state(), grad_accum={})
    step = build_train_step(model, loss_fn, optimizer, schedule)
    history = []
    with jax_f32():
        for images, targets, _ in batches:
            state, loss, head_losses = step(
                state, jnp.asarray(images),
                tuple(None if t is None else jnp.asarray(t)
                      for t in targets))
            history.append((float(loss), [None if l is None else float(l)
                                          for l in head_losses]))
    return history, state


def _port_trainer(variables, loss_attrs):
    metas = datasets.factory('cocokp-cocodet').head_metas
    model = port_narrow_shell(metas)
    convert_jax.load_jax_variables(model, variables)
    optimizer, schedule = optimize.factory_optimizer(
        optimizer_args(**OPT), training_batches_per_epoch=1)
    return Trainer(model, _loss_factory(losses.Factory, metas, loss_attrs),
                   optimizer, schedule, 'unused', device='cpu')


def _cifdet_weight(trainer):
    return trainer.model.head_nets[2].conv.weight.detach().clone()


CASES = {
    'lambdas': {'lambdas': [1.0, 2.0, 0.5]},
    'auto_tune_mtl': {'auto_tune_mtl': True},
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_three_mixed_steps_match_jax(case, mixed_batches, jax_variables):
    """cocokp, cocodet, cocokp: the absent heads' losses are None on both
    sides; the cocodet head moves in the cocokp steps (weight decay, then
    momentum), as optax moves a leaf whose gradient is zero; ``--lambdas``
    spans the mix's three heads (eight components: CifDet has no scale); ``--auto-tune-mtl`` skips the
    absent heads' components."""
    batches, _ = mixed_batches
    loss_attrs = CASES[case]
    ref, state = _run_jax(jax_variables, batches, loss_attrs)
    trainer = _port_trainer(jax_variables, loss_attrs)
    assert trainer.loss_fn.field_names == [
        'cocokp.cif.c', 'cocokp.cif.vec', 'cocokp.cif.scales',
        'cocokp.caf.c', 'cocokp.caf.vec', 'cocokp.caf.scales',
        'cocodet.cifdet.c', 'cocodet.cifdet.vec']
    ours = []
    cifdet = [_cifdet_weight(trainer)]
    for images, targets, metas in batches:
        targets = trainer._prepare_targets(targets, [{'head_indices': metas}])
        loss, head_losses = trainer.train_step(torch.from_numpy(images),
                                               targets)
        ours.append((float(loss), [None if l is None else float(l)
                                   for l in head_losses]))
        cifdet.append(_cifdet_weight(trainer))
    for (loss, heads), (ref_loss, ref_heads) in zip(ours, ref):
        assert [h is None for h in heads] == [h is None for h in ref_heads]
        np.testing.assert_allclose(loss, ref_loss, rtol=LOSS_RTOL)
        np.testing.assert_allclose([h for h in heads if h is not None],
                                   [h for h in ref_heads if h is not None],
                                   rtol=HEAD_RTOL)
    assert [[h is None for h in heads] for _, heads in ours] == [
        [False] * 6 + [True] * 2, [True] * 6 + [False] * 2,
        [False] * 6 + [True] * 2]
    assert all(not torch.equal(a, b) for a, b in zip(cifdet, cifdet[1:]))
    assert_state_close(trainer, state,
                       convert_jax.state_dict_from_jax(jax_variables))
    if loss_attrs.get('auto_tune_mtl'):
        assert_updates_close(
            {'s': trainer.loss_params['log_sigmas'].detach().numpy()},
            {'s': np.asarray(state.loss_params['log_sigmas'])}, {'s': 0.0})


# -- the train CLI -----------------------------------------------------------

def test_train_cli_trains_cocokp_cocodet(data, tmp_path):
    """``train --dataset cocokp-cocodet --dataset-weights 2 1 --device
    cpu`` with the full-width k16: the batches come in the mix's order,
    the logged head losses carry None for the absent heads, validation
    runs over the mix, and the checkpoint holds the three heads (head
    indices 0-2), which ``Predictor`` decodes through ``Multi`` of
    CifCaf and CifDet."""
    (kp_ann, kp_dir), (det_ann, det_dir) = data
    out = str(tmp_path / 'model')
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1',
               CUDA_VISIBLE_DEVICES='')
    done = subprocess.run(
        [sys.executable, '-m', 'openpifpaf_tpu_torch.train',
         '--dataset', 'cocokp-cocodet', '--dataset-weights', '2', '1',
         '--basenet', 'shufflenetv2k16',
         '--cocokp-train-annotations', kp_ann,
         '--cocokp-val-annotations', kp_ann,
         '--cocokp-train-image-dir', kp_dir,
         '--cocokp-val-image-dir', kp_dir,
         '--cocodet-train-annotations', det_ann,
         '--cocodet-val-annotations', det_ann,
         '--cocodet-train-image-dir', det_dir,
         '--cocodet-val-image-dir', det_dir,
         '--cocokp-square-edge', str(EDGE), '--cocodet-square-edge',
         str(EDGE), '--batch-size', '2', '--epochs', '1',
         '--log-interval', '1', '--device', 'cpu', '--output', out],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    with open(out + '.log') as f:
        lines = [json.loads(line) for line in f]
    steps = [line for line in lines if line.get('type') == 'train']
    assert [line['n_batches'] for line in steps] == [3, 3, 3]
    assert [[h is None for h in line['head_losses']] for line in steps] == [
        [False] * 6 + [True] * 2, [True] * 6 + [False] * 2,
        [False] * 6 + [True] * 2]
    val, = [line for line in lines if line.get('type') == 'val-epoch']
    assert val['n_batches'] == 3 and np.isfinite(val['loss'])
    assert all(h is not None for h in val['head_losses'])
    with open(out + '.json') as f:
        meta = json.load(f)
    assert [(m['dataset'], m['name'], m['head_index'])
            for m in meta['head_metas']] == [
        ('cocokp', 'cif', 0), ('cocokp', 'caf', 1), ('cocodet', 'cifdet', 2)]
    assert meta['args']['dataset_weights'] == WEIGHTS

    predictor = Predictor(checkpoint=out, device='cpu')
    assert [type(d).__name__ for d in predictor.processor.decoders] == \
        ['CifCaf', 'CifDet']
    image = np.random.RandomState(0).randint(0, 256, (97, 129, 3),
                                             dtype=np.uint8)
    pred, _, _ = predictor.numpy_image(image)
    assert isinstance(pred, list)
    assert [tuple(f.shape[1:3]) for f in predictor.fields_batch(
        predictor.preprocess(image, [], None)[0][None])] == [
        (17, 5), (19, 8), (80, 6)]


# -- the reference's tracking mix -----------------------------------------------

@pytest.fixture(scope='module')
def tracking_mix(tmp_path_factory):
    directory = tmp_path_factory.mktemp('tracking-mix')
    coco = write_synthetic_coco(str(directory / 'coco'), n_images=4,
                                image_hw=(113, 129), seed=1)
    posetrack = write_synthetic_posetrack2018(
        str(directory / 'posetrack'), n_sequences=1, n_frames=3,
        image_hw=(129, 225), seed=2)
    return coco, posetrack


def _tracking_batches(package, coco, posetrack):
    kp_cls, pt_cls, factory, assign = package
    with restored_statics(kp_cls, pt_cls):
        kp_cls.train_annotations, kp_cls.train_image_dir = coco
        pt_cls.train_annotations, _, pt_cls.data_root = posetrack
        kp_cls.square_edge = pt_cls.square_edge = EDGE
        datamodule = factory('cocokpst-posetrack2018')
        for dm in datamodule.datamodules:
            dm.batch_size = 2
        assign(datamodule.head_metas, STRIDE)
        np.random.seed(SEED)
        batches = list(datamodule.train_loader())
    return datamodule.head_metas, batches


def test_cocokpst_posetrack2018_mix_trains_as_jax(tracking_mix):
    """The reference trains tracking on ``cocokpst-posetrack2018``; the
    JAX package runs it on the CPU (``MultiLoader`` passes pair batches
    through, the TrackingShell gets the six heads of both datasets), so
    the port runs it too: equal batches, then a step on a cocokpst pair
    and one on a posetrack2018 pair with equal losses, None for the
    other dataset's heads."""
    metas, ours = _tracking_batches(
        (CocoKp, Posetrack2018, datasets.factory, assign_strides),
        *tracking_mix)
    jax_metas, ref = _tracking_batches(
        (JaxCocoKp, JaxPosetrack2018, openpifpaf_tpu.datasets.factory,
         jax_assign_strides), *tracking_mix)
    assert [(m.dataset, m.name, type(m).__name__) for m in metas] == \
        [(m.dataset, m.name, type(m).__name__) for m in jax_metas]
    assert len(metas) == 6
    assert len(ours) == len(ref)
    for (images, targets, _), (r_images, r_targets, _) in zip(ours, ref):
        np.testing.assert_array_equal(images, r_images)
        for t, r in zip(targets, r_targets):
            assert (t is None) == (r is None)
            if t is not None:
                np.testing.assert_array_equal(t, r)
    picked = [next(b for b in ours if b[1][0] is not None),
              next(b for b in ours if b[1][3] is not None)]

    model = jax_narrow_tracking_shell(jax_metas)
    variables = numpy_variables(jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((2, 65, 65, 3)),
                           train=True)), seed=5)
    loss_fn = jax_losses.Factory().factory(jax_metas)
    optimizer, schedule = jax_optimize.factory_optimizer(
        optimizer_args(**OPT), training_batches_per_epoch=1)
    params = variables['params']
    loss_params = loss_fn.init_params()
    state = TrainState(
        params=params, batch_stats=variables['batch_stats'],
        opt_state=optimizer.init({'model': params, 'loss': loss_params}),
        ema_params=params, step=jnp.zeros((), dtype=jnp.int32),
        loss_params=loss_params, loss_state=loss_fn.init_state(),
        grad_accum={})
    step = build_train_step(model, loss_fn, optimizer, schedule)

    port_model = port_narrow_shell(metas)
    convert_jax.load_jax_variables(port_model, variables)
    optimizer, schedule = optimize.factory_optimizer(
        optimizer_args(**OPT), training_batches_per_epoch=1)
    trainer = Trainer(port_model, losses.Factory().factory(metas), optimizer,
                      schedule, 'unused', device='cpu')
    for images, targets, _ in picked:
        with jax_f32():
            state, ref_loss, ref_heads = step(
                state, jnp.asarray(images),
                tuple(None if t is None else jnp.asarray(t)
                      for t in targets))
        loss, heads = trainer.train_step(
            torch.from_numpy(images),
            tuple(None if t is None else torch.from_numpy(t)
                  for t in targets))
        assert [h is None for h in heads] == [h is None for h in ref_heads]
        np.testing.assert_allclose(float(loss), float(ref_loss),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(
            [float(h) for h in heads if h is not None],
            [float(h) for h in ref_heads if h is not None], rtol=HEAD_RTOL)
    assert [h is None for h in heads] == [True] * 9 + [False] * 9
