"""The training slice as a whole: CocoKp -> Trainer.loop -> checkpoint ->
load_shell -> Predictor, against the JAX package's Trainer.loop, and the
port's train and predict CLIs on the CPU.

Both trainers take the same narrow ShuffleNetV2K (flax variables,
BatchNorm randomised, bridged) through one epoch of two batches of their
own CocoKp loaders on a synthetic COCO set, with the global ``np.random``
seeded alike (the pipelines then give the same batches), with the CLI's
default optimizer and schedule. The port's final checkpoint must hold the
JAX trainer's EMA parameters and BatchNorm statistics within the trainer
test's tolerance (10% of each tensor's update plus 1e-3 of the largest,
rtol 2e-6), its logged losses must agree (rtol 1e-4), and a Predictor
loaded from it must serve the fields of the model that wrote it, exactly,
and the JAX model's fields on the JAX state within atol 1e-4.
"""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpifpaf_tpu.plugins.coco.cocokp import CocoKp as JaxCocoKp
from openpifpaf_tpu.training import losses as jax_losses
from openpifpaf_tpu.training import optimize as jax_optimize
from openpifpaf_tpu.training.trainer import Trainer as JaxTrainer
from openpifpaf_tpu_torch.models import basenetworks, convert_jax
from openpifpaf_tpu_torch.models import factory as models_factory
from openpifpaf_tpu_torch.plugins.coco.cocokp import CocoKp
from openpifpaf_tpu_torch.predictor import Predictor
from openpifpaf_tpu_torch.training import checkpoint, losses, optimize
from openpifpaf_tpu_torch.training.trainer import Trainer

from torch_port_helpers import NARROW, jax_f32, jax_narrow_shell, \
    one_torch_thread, optimizer_args, port_narrow_shell, \
    randomize_variables, write_synthetic_coco

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 3
NARROW_NAME = 'shufflenetv2k-narrow'


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    one_torch_thread()


@pytest.fixture(scope='module')
def coco(tmp_path_factory):
    return write_synthetic_coco(str(tmp_path_factory.mktemp('coco')),
                                n_images=6, image_hw=(97, 129), seed=2)


def _datamodule(cls, coco):
    ann_file, image_dir = coco
    return cls(train_annotations=ann_file, val_annotations=ann_file,
               train_image_dir=image_dir, val_image_dir=image_dir,
               square_edge=97, batch_size=2)


def _log_lines(path, kind):
    with open(path) as f:
        lines = [json.loads(line) for line in f]
    return [line for line in lines if line.get('type') == kind]


def _attrs(trainer):
    trainer.epochs = 1
    trainer.n_train_batches = 2
    trainer.n_val_batches = 1
    trainer.log_interval = 1


def _logged(out):
    import logging
    from openpifpaf_tpu_torch.logger import JsonFormatter
    handler = logging.FileHandler(out + '.log', mode='w')
    handler.setFormatter(JsonFormatter())
    handler.setLevel(logging.INFO)
    return handler


def _run_jax(coco, variables, out):
    datamodule = _datamodule(JaxCocoKp, coco)
    model = jax_narrow_shell(datamodule.head_metas)
    loss_fn = jax_losses.Factory().factory(datamodule.head_metas)
    train_loader = datamodule.train_loader()
    optimizer, schedule = jax_optimize.factory_optimizer(
        optimizer_args(), training_batches_per_epoch=len(train_loader))
    trainer = JaxTrainer(model, loss_fn, optimizer, schedule, out,
                         variables=variables)
    _attrs(trainer)
    np.random.seed(SEED)
    with jax_f32():
        trainer.loop(train_loader, datamodule.val_loader())
    return model, trainer


def _run_port(coco, variables, out, monkeypatch):
    monkeypatch.setitem(models_factory.BASE_FACTORIES, NARROW_NAME,
                        lambda: basenetworks.ShuffleNetV2K(*NARROW))
    datamodule = _datamodule(CocoKp, coco)
    model = port_narrow_shell(datamodule.head_metas)
    convert_jax.load_jax_variables(model, variables)
    loss_fn = losses.Factory().factory(datamodule.head_metas)
    train_loader = datamodule.train_loader()
    optimizer, schedule = optimize.factory_optimizer(
        optimizer_args(), training_batches_per_epoch=len(train_loader))
    trainer = Trainer(model, loss_fn, optimizer, schedule, out, device='cpu',
                      model_meta_data={
                          'base_name': NARROW_NAME,
                          'head_metas': [checkpoint.headmeta_to_dict(m)
                                         for m in datamodule.head_metas]})
    _attrs(trainer)
    np.random.seed(SEED)
    trainer.loop(train_loader, datamodule.val_loader())
    return trainer


def test_train_loop_checkpoint_predictor_match_jax(coco, tmp_path,
                                                   monkeypatch, request):
    import logging
    model = jax_narrow_shell(_datamodule(JaxCocoKp, coco).head_metas)
    variables = jax.tree_util.tree_map(np.asarray, randomize_variables(
        model.init(jax.random.PRNGKey(0), jnp.zeros((1, 65, 65, 3)),
                   train=True), seed=12))

    # setLevel, not an attribute write: it also drops every logger's
    # cached isEnabledFor, which an earlier test in this process may have
    # filled under the default WARNING (the trainers then log nothing)
    root = logging.getLogger('')
    request.addfinalizer(functools.partial(root.setLevel, root.level))
    root.setLevel(logging.INFO)
    logs = {}
    for name, run in (('jax', lambda out: _run_jax(coco, variables, out)),
                      ('port', lambda out: _run_port(coco, variables, out,
                                                     monkeypatch))):
        out = str(tmp_path / name / 'model')
        os.makedirs(os.path.dirname(out))
        handler = _logged(out)
        root.addHandler(handler)
        try:
            logs[name] = run(out)
        finally:
            root.removeHandler(handler)
            handler.close()
    jax_model, jax_trainer = logs['jax']
    out = str(tmp_path / 'port' / 'model')
    for suffix in ('.epoch000', '.epoch001', ''):
        assert os.path.exists(out + suffix + '.json')
        assert os.path.exists(out + suffix + '.pt')

    # the logged losses, batch by batch, and the validation
    for kind in ('train', 'val-epoch'):
        ours = _log_lines(out + '.log', kind)
        ref = _log_lines(str(tmp_path / 'jax' / 'model') + '.log', kind)
        assert len(ours) == len(ref) == (2 if kind == 'train' else 1)
        for a, b in zip(ours, ref):
            assert set(a) == set(b)
            np.testing.assert_allclose(a['loss'], b['loss'], rtol=1e-4)
            if kind == 'train':
                assert a['lr'] == pytest.approx(b['lr'], rel=1e-6)

    # the checkpoint holds the JAX trainer's EMA and BatchNorm statistics
    state = jax_trainer.state
    ref = convert_jax.state_dict_from_jax(
        {'params': state.ema_params, 'batch_stats': state.batch_stats})
    start = convert_jax.state_dict_from_jax(variables)
    loaded, meta = checkpoint.load_shell(out)
    assert meta['epoch'] == 1 and meta['base_name'] == NARROW_NAME
    ours = loaded.state_dict()
    names = [n for n in ref if not n.endswith('num_batches_tracked')]
    floor = max(float((ref[n] - start[n]).abs().max()) for n in names)
    for name in names:
        update = float((ref[name] - start[name]).abs().max())
        np.testing.assert_allclose(ours[name].numpy(), ref[name].numpy(),
                                   rtol=2e-6, atol=0.1 * update + 1e-3 * floor,
                                   err_msg=name)

    # a Predictor of the checkpoint serves the writer's fields
    port_trainer = logs['port']
    image = np.random.RandomState(4).randint(0, 256, (81, 97, 3),
                                             dtype=np.uint8)
    predictor = Predictor(checkpoint=out, device='cpu')
    batch = predictor.preprocess(image, [], None)[0][None]
    fields = predictor.fields_batch(batch)
    writer = port_narrow_shell(predictor.head_metas)
    writer.load_state_dict(port_trainer.ema_state_dict())
    with torch.no_grad():
        expected = writer.eval()(torch.from_numpy(
            predictor._bucket_pad(batch)))
    for f, e in zip(fields, expected):
        np.testing.assert_array_equal(f.numpy(), e.numpy())
    with jax_f32():
        jax_fields = jax_model.apply(
            {'params': state.ema_params, 'batch_stats': state.batch_stats},
            jnp.asarray(predictor._bucket_pad(batch)))
    for f, r in zip(fields, jax_fields):
        np.testing.assert_allclose(f.numpy(), np.asarray(r), atol=1e-4,
                                   rtol=0)
    assert len(list(predictor.numpy_images([image]))) == 1


def _run(args, env, timeout=240):
    done = subprocess.run([sys.executable, '-m', *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout,
                          check=False)
    return done


def test_train_and_predict_clis_on_cpu(coco, tmp_path):
    """``python -m openpifpaf_tpu_torch.train --device cpu`` writes a
    checkpoint of the default k16 that ``predict --checkpoint`` serves
    and ``train --checkpoint`` resumes; without ``--device cpu`` and
    without a card, train raises."""
    ann_file, image_dir = coco
    out = str(tmp_path / 'model')
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1',
               CUDA_VISIBLE_DEVICES='')
    flags = ['--dataset', 'cocokp', '--basenet', 'shufflenetv2k16',
             '--cocokp-train-annotations', ann_file,
             '--cocokp-val-annotations', ann_file,
             '--cocokp-train-image-dir', image_dir,
             '--cocokp-val-image-dir', image_dir,
             '--cocokp-square-edge', '97', '--batch-size', '2',
             '--epochs', '1', '--train-batches', '2', '--val-batches', '1',
             '--log-interval', '1', '--output', out]
    done = _run(['openpifpaf_tpu_torch.train', *flags, '--device', 'cpu'],
                env)
    assert done.returncode == 0, done.stderr[-3000:]
    lines = _log_lines(out + '.log', 'train')
    assert len(lines) == 2
    assert all(np.isfinite(line['loss']) for line in lines)
    with open(out + '.json') as f:
        meta = json.load(f)
    assert meta['base_name'] == 'shufflenetv2k16' and meta['epoch'] == 1
    assert meta['backbone_options']['shufflenetv2k']['kernel'] == 5
    assert [m['name'] for m in meta['head_metas']] == ['cif', 'caf']

    image = os.path.join(image_dir, sorted(os.listdir(image_dir))[0])
    done = _run(['openpifpaf_tpu_torch.predict', image, '--checkpoint', out,
                 '--device', 'cpu', '--json-output', str(tmp_path)], env)
    assert done.returncode == 0, done.stderr[-3000:]
    with open(os.path.join(str(tmp_path), os.path.basename(image))
              + '.predictions.json') as f:
        assert isinstance(json.load(f), list)

    # --checkpoint resumes at the checkpoint's epoch
    resumed = str(tmp_path / 'resumed')
    done = _run(['openpifpaf_tpu_torch.train', *flags, '--device', 'cpu',
                 '--checkpoint', out, '--epochs', '2', '--output', resumed],
                env)
    assert done.returncode == 0, done.stderr[-3000:]
    assert [line['epoch'] for line in _log_lines(resumed + '.log',
                                                 'train')] == [1, 1]
    with open(resumed + '.json') as f:
        assert json.load(f)['epoch'] == 2
    assert not os.path.exists(resumed + '.epoch000.json')

    done = _run(['openpifpaf_tpu_torch.train', *flags], env)
    assert done.returncode != 0
    assert 'no CUDA device' in done.stderr
