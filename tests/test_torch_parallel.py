"""The port's data-parallel distribution (``openpifpaf_tpu_torch/parallel``,
DDP training with the cross-rank BatchNorm, ``predict --n-devices``)
against the JAX package's ``parallel`` on its virtual CPU devices and
against the port's own single-process step.

Tolerances: the sharded forward's fields within 1e-5 of JAX's unsharded
(JAX on two of the conftest's virtual CPU devices, float32); the
two-process gloo step's losses (rtol) and parameters, BatchNorm buffers
and EMA (atol) within 1e-5 of the single-process step on the same global
batch (both in float64, where the ranks' other order of the reductions
stays far below it); the cross-rank BatchNorm within 1e-5 of the global
batch's BatchNorm in float64. The ranks run as subprocesses with their
own timeout.
"""

import argparse
import logging
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from openpifpaf_tpu import parallel as jax_parallel
from openpifpaf_tpu_torch import parallel, train
from openpifpaf_tpu_torch.models import convert_jax
from openpifpaf_tpu_torch.models.shell import assign_strides
from openpifpaf_tpu_torch.plugins.coco.cocokp import CocoKp
from openpifpaf_tpu_torch.predictor import Predictor

from torch_port_helpers import jax_f32, jax_metas, jax_narrow_shell, \
    one_torch_thread, port_metas, port_narrow_shell, randomize_variables, \
    write_synthetic_coco

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
FIELD_ATOL = 1e-5
STEP_TOL = 1e-5
BN_TOL = 1e-5
WORKER_TIMEOUT = 120


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    one_torch_thread()


@pytest.fixture(scope='module')
def narrow():
    """(JAX shell, its variables, the port's model) of one narrow
    ShuffleNetV2K with the cocokp heads, BatchNorm randomised."""
    model = jax_narrow_shell(jax_metas(16))
    variables = jax.tree_util.tree_map(np.asarray, randomize_variables(
        model.init(jax.random.PRNGKey(0), jnp.zeros((1, 65, 65, 3)),
                   train=True), seed=11))
    port_model = port_narrow_shell(port_metas(16))
    convert_jax.load_jax_variables(port_model, variables)
    return model, variables, port_model.eval()


def test_mesh_slices_and_shards():
    mesh = parallel.data_mesh(2, device_type='cpu')
    assert mesh.devices == [torch.device('cpu')] * 2 and mesh.group is None
    assert parallel.local_batch_slice(6) == slice(0, 6)
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    parts = parallel.shard_batch((x, x + 1), mesh)
    assert len(parts) == 2
    np.testing.assert_array_equal(parts[1][0].numpy(), x[3:])
    np.testing.assert_array_equal(parts[1][1].numpy(), x[3:] + 1)
    jax_parts = jax_parallel.shard_batch(x, jax_parallel.data_mesh(2))
    np.testing.assert_array_equal(
        np.concatenate([p.numpy() for p in parallel.shard_batch(x, mesh)]),
        np.asarray(jax_parts))
    with pytest.raises(ValueError, match='not divisible'):
        parallel.shard_batch(x[:5], mesh)


def jax_mesh_devices(n_devices, batch_size, spatial):
    """The devices of JAX's train mesh (``openpifpaf_tpu/train.py:140-146``,
    the rule as written there): a batch times spatial below the devices
    shrinks the data mesh."""
    spatial = max(1, spatial)
    if batch_size * spatial < n_devices:
        n_devices = max(spatial, batch_size * spatial)
    return n_devices


@pytest.mark.parametrize('n_devices,batch_size,spatial', [
    (4, 2, 1), (4, 1, 2), (4, 2, 2), (2, 8, 1), (8, 1, 4), (6, 3, 1)])
def test_train_mesh_shrinks_as_jax(n_devices, batch_size, spatial, caplog):
    """``train --device cpu --n-devices N``: a batch below N (times the
    spatial partitions) warns and spawns JAX's count of ranks, not raise."""
    args = argparse.Namespace(device='cpu', n_devices=n_devices,
                              batch_size=batch_size,
                              spatial_partitions=spatial)
    want = jax_mesh_devices(n_devices, batch_size, spatial)
    with caplog.at_level(logging.WARNING, logger=train.LOG.name):
        group, rank, world_size, device = train._process_group(args, [])
    assert (group, rank, device) == (None, None, None)
    assert world_size == want
    assert ('shrinking the data mesh' in caplog.text) == (want < n_devices)


def test_train_mesh_needs_spatial_to_divide_it():
    args = argparse.Namespace(device='cpu', n_devices=6, batch_size=8,
                              spatial_partitions=4)
    with pytest.raises(ValueError, match='not divisible by spatial=4'):
        train._process_group(args, [])


@pytest.mark.parametrize('batch', [4, 3])
def test_sharded_forward_equals_jax(narrow, batch):
    """Two CPU replicas; a batch of 3 is padded with its last image and
    trimmed back."""
    model, variables, port_model = narrow
    images = np.random.RandomState(batch).randn(batch, 65, 65, 3).astype(
        np.float32)
    sharded = parallel.ShardedForward(
        port_model, mesh=parallel.data_mesh(2, device_type='cpu'))
    assert sharded.n_devices == 2 and sharded.replicas[0] is not port_model
    with torch.no_grad():
        ours = sharded(torch.from_numpy(images))
    padded = np.concatenate([images] + [images[-1:]] * (-batch % 2))
    with jax_f32():
        ref = jax_parallel.ShardedForward(
            model, variables, mesh=jax_parallel.data_mesh(2))(padded)
    for o, r in zip(ours, ref):
        assert o.shape[0] == batch
        np.testing.assert_allclose(o.numpy(), np.asarray(r)[:batch],
                                   rtol=0, atol=FIELD_ATOL)


def test_predictor_n_devices(narrow):
    """``Predictor(n_devices=2)`` on the CPU forwards through two
    replicas and gives the single-device fields; on CUDA more devices
    than are visible raise."""
    port_model = narrow[2]
    images = np.random.RandomState(1).randint(
        0, 256, (3, 65, 81, 3)).astype(np.uint8)
    single = Predictor(model=port_model, device='cpu')
    sharded = Predictor(model=port_model, device='cpu', n_devices=2)
    assert sharded._sharded.n_devices == 2
    for a, b in zip(single.fields_batch(images),
                    sharded.fields_batch(images)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                   atol=FIELD_ATOL)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            Predictor(model=port_model, n_devices=2)


def _free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    env.pop('JAX_PLATFORMS', None)
    return env


@pytest.fixture(scope='module')
def ddp_run(tmp_path_factory, narrow):
    """The global batch (4 crops of the port's CocoKp pipeline), the
    start state, and the two ranks' results."""
    workdir = tmp_path_factory.mktemp('ddp')
    ann_file, image_dir = write_synthetic_coco(
        str(workdir / 'coco'), n_images=4, image_hw=(97, 129), seed=3)
    datamodule = CocoKp(train_annotations=ann_file,
                        train_image_dir=image_dir, square_edge=65,
                        augmentation=False, batch_size=4)
    assign_strides(datamodule.head_metas, 16)
    np.random.seed(5)  # CenterPad draws its fill colour
    images, (cif, caf), _ = next(iter(datamodule.train_loader()))
    rng = np.random.RandomState(7)
    np.savez(workdir / 'batch.npz', images=images, cif=cif, caf=caf,
             bn_x=rng.randn(4, 6, 5, 7), bn_grad=rng.randn(4, 6, 5, 7))
    start = {k: v.clone() for k, v in narrow[2].state_dict().items()}
    torch.save(start, workdir / 'start.pt')
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, 'torch_ddp_worker.py'),
         str(rank), '2', str(port), str(workdir)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in range(2)]
    try:
        outs = [p.communicate(timeout=WORKER_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out.decode()[-3000:]
    ranks = [torch.load(workdir / f'rank{r}.pt') for r in range(2)]
    return np.load(workdir / 'batch.npz'), start, ranks


def test_two_process_ddp_step_equals_single_process(ddp_run):
    sys.path.insert(0, HERE)
    import torch_ddp_worker
    batch, start, ranks = ddp_run
    trainer = torch_ddp_worker.build_trainer(start)
    history = torch_ddp_worker.train(
        trainer, torch.from_numpy(batch['images']),
        (torch.from_numpy(batch['cif']), torch.from_numpy(batch['caf'])))
    for rank in ranks:
        np.testing.assert_allclose(rank['history'], history, rtol=STEP_TOL)
    ours = ranks[0]['state']
    ref = trainer.model.state_dict()
    moved = max(float((ref[k] - start[k]).abs().max()) for k in ref)
    assert moved > 100 * STEP_TOL
    for name, value in ref.items():
        np.testing.assert_allclose(ours[name].numpy(), value.numpy(),
                                   rtol=0, atol=STEP_TOL, err_msg=name)
        np.testing.assert_array_equal(ranks[1]['state'][name].numpy(),
                                      ours[name].numpy())
    for mine, theirs in zip(ranks[0]['ema'], trainer.ema):
        np.testing.assert_allclose(mine.numpy(), theirs.numpy(), rtol=0,
                                   atol=STEP_TOL)


def test_running_variance_normaliser_in_step_across_ranks(ddp_run):
    """Each rank's buffer takes the mean of the ranks' losses: equal on
    both ranks and to the single-process buffer of the global batch."""
    sys.path.insert(0, HERE)
    import torch_ddp_worker
    batch, start, ranks = ddp_run
    buffers = [r['loss_state']['buffer'].numpy() for r in ranks]
    np.testing.assert_array_equal(buffers[0], buffers[1])
    trainer = torch_ddp_worker.build_trainer(start)
    torch_ddp_worker.train(
        trainer, torch.from_numpy(batch['images']),
        (torch.from_numpy(batch['cif']), torch.from_numpy(batch['caf'])))
    ref = trainer.loss_state['buffer'].numpy()
    written = ~np.isnan(ref)
    assert written.sum() == 2 * ref.shape[0]
    np.testing.assert_array_equal(np.isnan(buffers[0]), ~written)
    np.testing.assert_allclose(buffers[0][written], ref[written],
                               rtol=STEP_TOL)


def test_cross_rank_batch_norm_equals_global_batch(ddp_run):
    batch, _, ranks = ddp_run
    x = torch.from_numpy(batch['bn_x']).requires_grad_()
    c = x.shape[1]
    weight = torch.linspace(0.5, 1.5, c, dtype=x.dtype).requires_grad_()
    bias = torch.linspace(-0.2, 0.2, c, dtype=x.dtype).requires_grad_()
    y = F.batch_norm(x, None, None, weight, bias, True, 0.0, 1e-3)
    y.backward(torch.from_numpy(batch['bn_grad']))
    bn = [r['bn'] for r in ranks]
    np.testing.assert_allclose(
        torch.cat([b['y'] for b in bn]).numpy(), y.detach().numpy(),
        rtol=0, atol=BN_TOL)
    np.testing.assert_allclose(
        torch.cat([b['grad_x'] for b in bn]).numpy(), x.grad.numpy(),
        rtol=0, atol=BN_TOL)
    for name, ref in (('grad_weight', weight.grad), ('grad_bias', bias.grad)):
        np.testing.assert_allclose((bn[0][name] + bn[1][name]).numpy(),
                                   ref.numpy(), rtol=0, atol=BN_TOL)
    xd = x.detach()
    np.testing.assert_allclose(bn[0]['mean'].numpy(),
                               xd.mean((0, 2, 3)).numpy(), atol=BN_TOL)
    np.testing.assert_allclose(bn[1]['var'].numpy(),
                               xd.var((0, 2, 3), unbiased=False).numpy(),
                               atol=BN_TOL)


def test_train_cli_spawns_gloo_ranks(tmp_path):
    """``train --device cpu --n-devices 2`` spawns two gloo ranks, each
    on its shard; rank 0 alone writes the checkpoints and the log."""
    ann_file, image_dir = write_synthetic_coco(
        str(tmp_path / 'coco'), n_images=4, image_hw=(97, 129), seed=3)
    out = str(tmp_path / 'model')
    done = subprocess.run(
        [sys.executable, '-m', 'openpifpaf_tpu_torch.train',
         '--dataset', 'cocokp', '--cocokp-train-annotations', ann_file,
         '--cocokp-val-annotations', ann_file,
         '--cocokp-train-image-dir', image_dir,
         '--cocokp-val-image-dir', image_dir,
         '--cocokp-square-edge', '65', '--cocokp-no-augmentation',
         '--batch-size', '2', '--epochs', '1', '--train-batches', '1',
         '--val-batches', '1', '--device', 'cpu', '--n-devices', '2',
         '--output', out],
        env=_env(), capture_output=True, text=True, timeout=WORKER_TIMEOUT)
    assert done.returncode == 0, done.stderr[-3000:]
    assert os.path.exists(out + '.pt') and os.path.exists(out + '.epoch001.pt')
    with open(out + '.log') as f:
        lines = f.read().splitlines()
    assert sum('"train-epoch"' in line for line in lines) == 1
    assert sum('"val-epoch"' in line for line in lines) == 1
