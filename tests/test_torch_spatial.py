"""The port's ``('data', 'space')`` mesh (``parallel/mesh.py::grid_mesh``,
``parallel/spatial.py``, ``parallel/spatial_model.py``, the engines on
shards in ``models/fused_inference.py``, ``ShardedForward``, the
Predictor's ``spatial_devices``, the Trainer's ``spatial`` step and
``train --spatial-partitions``) against the JAX package's
``tests/test_parallel.py`` and ``tests/test_multihost.py`` spatial tests
on its virtual CPU devices, and against the port's own unsharded runs.

Tolerances: against JAX, JAX's own (the forward and the Predictor rtol
2e-4, atol 2e-5; the step's loss rtol 1e-4, its parameters rtol 1e-3,
atol 1e-5), JAX in float32 matmul precision; the port sharded against
unsharded in float64: the forward within 1e-10, the step within 1e-9
(the sharded sums run in another order); the engines in float32 within
1e-5 of their own unsharded forward; two gloo ranks' losses equal to each
other and within rel 1e-4 of the one-process grid mesh, as JAX's test.
"""

import os
import socket
import subprocess
import sys

import hypothesis
import hypothesis.strategies as st
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import openpifpaf_tpu
from openpifpaf_tpu import parallel as jax_parallel
from openpifpaf_tpu.models import factory as jax_factory
from openpifpaf_tpu.predictor import Predictor as JaxPredictor
from openpifpaf_tpu.training import losses as jax_losses
from openpifpaf_tpu.training import optimize as jax_optimize
from openpifpaf_tpu.training.trainer import TrainState, build_train_step
from openpifpaf_tpu_torch import parallel
from openpifpaf_tpu_torch.models import convert_jax, fused_inference, \
    shuffle_cuda
from openpifpaf_tpu_torch.models.factory import Factory
from openpifpaf_tpu_torch.parallel import spatial
from openpifpaf_tpu_torch.predictor import Predictor

from torch_port_helpers import jax_f32, one_torch_thread, port_metas, \
    port_narrow_shell, write_synthetic_coco

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
import torch_spatial_worker  # noqa: E402

JAX_TOL = dict(rtol=2e-4, atol=2e-5)
FORWARD_F64_ATOL = 1e-10
STEP_F64_ATOL = 1e-9
ENGINE_ATOL = 1e-5
LOSS_RTOL = 1e-4
PARAM_TOL = dict(rtol=1e-3, atol=1e-5)
RANKS_RTOL = 1e-4
WORKER_TIMEOUT = 240


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    one_torch_thread()


@pytest.fixture(scope='module')
def resnet18():
    """(JAX model, its variables, the port's model) of JAX's tests:
    resnet18 with the cocokp heads, ``PRNGKey(0)`` at (1, 65, 65, 3)."""
    datamodule = openpifpaf_tpu.datasets.factory('cocokp')
    model, init_fn = jax_factory.Factory(base_name='resnet18').from_scratch(
        datamodule.head_metas)
    variables = jax.tree_util.tree_map(
        np.asarray, init_fn(jax.random.PRNGKey(0), (1, 65, 65, 3)))
    port_model = Factory(base_name='resnet18').from_scratch(
        port_metas(16), generator=torch.Generator().manual_seed(0))
    convert_jax.load_jax_variables(port_model, variables)
    return model, variables, port_model.eval()


def _narrow_model(seed=0):
    """A narrow k16 with the cocokp heads, its BatchNorm running
    statistics drawn from ``seed``."""
    model = port_narrow_shell(port_metas(16))
    rng = np.random.RandomState(seed)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            c = m.num_features
            m.running_mean.copy_(torch.from_numpy(0.1 * rng.randn(c)))
            m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c)))
            m.bias.data.copy_(torch.from_numpy(0.1 * rng.randn(c)))
    return model.eval()


def test_grid_mesh_shapes():
    """``test_parallel.py::test_grid_mesh_shapes``: (4, 2) over 8 devices,
    ``spatial=1`` the data axis, a spatial axis that does not divide the
    devices raises."""
    mesh = parallel.grid_mesh(8, spatial=2, device_type='cpu')
    ref = jax_parallel.grid_mesh(8, spatial=2)
    assert mesh.axis_names == ref.axis_names == ('data', 'space')
    assert mesh.shape == ref.devices.shape == (4, 2)
    assert mesh.cells()[:3] == [(0, 0), (0, 1), (1, 0)]
    axes = mesh.space_axes()
    assert [d for d, _ in axes] == [0, 1, 2, 3]
    assert all(a.local == (0, 1) and a.owners is None for _, a in axes)
    one = parallel.grid_mesh(8, spatial=1, device_type='cpu')
    assert isinstance(one, parallel.DataMesh) and len(one.devices) == 8
    assert jax_parallel.grid_mesh(8, spatial=1).axis_names == ('data',)
    with pytest.raises(ValueError, match='not divisible'):
        parallel.grid_mesh(8, spatial=3, device_type='cpu')
    with pytest.raises(ValueError):
        jax_parallel.grid_mesh(8, spatial=3)


def test_shardings_split_batch_and_rows():
    mesh = parallel.grid_mesh(4, spatial=2, device_type='cpu')
    images = torch.arange(2 * 5 * 3 * 1).reshape(2, 5, 3, 1)
    parts = parallel.image_sharding(mesh).shard(images)
    assert [tuple(p.shape) for p in parts] == [(1, 3, 3, 1), (1, 2, 3, 1)] * 2
    torch.testing.assert_close(torch.cat(parts[2:], dim=1), images[1:])
    fields = torch.zeros(2, 17, 5, 5, 4)
    assert [p.shape[3] for p in
            parallel.field_sharding(mesh).shard(fields)] == [3, 2, 3, 2]
    assert all(p.shape == fields.shape
               for p in parallel.replicate(mesh).shard(fields))
    data = parallel.image_sharding(parallel.grid_mesh(
        2, spatial=1, device_type='cpu')).shard(images)
    assert [tuple(p.shape) for p in data] == [(1, 5, 3, 1)] * 2


@hypothesis.settings(max_examples=300, deadline=None)
@hypothesis.given(height=st.integers(1, 100),
                  kernel=st.sampled_from((1, 3, 5, 7)),
                  stride=st.sampled_from((1, 2)),
                  dilation=st.sampled_from((1, 2)), shards=st.integers(1, 4),
                  data=st.data())
def test_row_plan_tiles_every_layer(height, kernel, stride, dilation, shards,
                                    data):
    """The owned output ranges tile the output exactly, and every output
    row reads rows that are its shard's fetched rows or padding."""
    padding = data.draw(st.integers(0, (kernel - 1) // 2 * dilation))
    op = spatial.RowOp(kernel, stride, padding, dilation)
    out_h = op.out_height(height)
    hypothesis.assume(out_h >= 1)
    ranges = spatial.split_rows(out_h, shards)
    assert ranges[0][0] == 0 and ranges[-1][1] == out_h
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(s <= e for s, e in ranges)
    for s, e in ranges:
        if s == e:
            continue
        a, b, top, bottom = op.fetch(s, e, height)
        assert 0 <= a <= b <= height and top >= 0 and bottom >= 0
        # the padded tile is what the op reads for rows s .. e - 1
        assert a - top == s * stride - padding
        assert top + (b - a) + bottom == \
            (e - 1 - s) * stride + (kernel - 1) * dilation + 1
        for row in range(s, e):
            for tap in range(kernel):
                src = row * stride - padding + tap * dilation
                assert a <= src < b or src < 0 or src >= height


@pytest.mark.parametrize('shards', [2, 3, 4])
def test_exchange_local_side_gradcheck(shards):
    """The local side: slicing that autograd differentiates, float64."""
    x = torch.from_numpy(np.random.RandomState(shards).randn(
        *torch_spatial_worker.CHECK_SHAPE)).requires_grad_()
    axis = spatial.SpaceAxis.in_process(shards, 'cpu')
    halo = torch_spatial_worker.CHECK_HALO

    def tiles(t):
        rows = spatial.Rows.split(t, axis)
        want = [(max(s - halo, 0), min(e + halo, rows.height)) if s < e
                else None for s, e in rows.ranges]
        return torch.cat(spatial.exchange(rows, want), dim=2)

    assert torch.autograd.gradcheck(tiles, (x,))
    # each shard's tile is its rows plus the halo, clipped at the edges
    ranges = spatial.split_rows(x.shape[2], shards)
    expected = torch.cat([x[:, :, max(s - halo, 0):min(e + halo, 7)]
                          for s, e in ranges if s < e], dim=2)
    torch.testing.assert_close(tiles(x), expected, rtol=0, atol=0)


@pytest.mark.parametrize('shards', [2, 4])
def test_row_op_conv_and_pool_gradcheck(shards):
    """A stride-2 conv and a max pool through the row plan, float64."""
    rng = np.random.RandomState(shards)
    x = torch.from_numpy(rng.randn(1, 2, 9, 5)).requires_grad_()
    w = torch.from_numpy(rng.randn(3, 2, 3, 3)).requires_grad_()
    axis = spatial.SpaceAxis.in_process(shards, 'cpu')

    def conv(t, w):
        rows = spatial.row_op(spatial.Rows.split(t, axis),
                              spatial.RowOp(3, 2, 1),
                              lambda k, x: F.conv2d(x, w, stride=2,
                                                    padding=(0, 1)))
        return spatial.gather(rows, 'cpu')

    def pool(t):
        rows = spatial.row_op(spatial.Rows.split(t, axis),
                              spatial.RowOp(3, 2, 1),
                              lambda k, x: F.max_pool2d(x, 3, 2, (0, 1)),
                              pad_value=-np.inf)
        return spatial.gather(rows, 'cpu')

    torch.testing.assert_close(conv(x, w), F.conv2d(x, w, stride=2,
                                                    padding=1))
    torch.testing.assert_close(pool(x), F.max_pool2d(x, 3, 2, 1))
    assert torch.autograd.gradcheck(conv, (x, w))
    assert torch.autograd.gradcheck(pool, (x,))


def test_spatial_sharded_forward_parity(resnet18):
    """``test_parallel.py::test_spatial_sharded_forward_parity``: resnet18,
    65x65, spatial 4 over 8 CPU devices, against JAX's forward, and
    against the port's unsharded forward in float64."""
    model, variables, port_model = resnet18
    images = np.random.RandomState(0).randn(2, 65, 65, 3).astype(np.float32)
    with jax_f32():
        ref = jax.jit(lambda v, im: model.apply(v, im, train=False))(
            variables, images)
    mesh = parallel.grid_mesh(8, spatial=4, device_type='cpu')
    sharded = parallel.ShardedForward(port_model, mesh=mesh)
    with torch.no_grad():
        out = sharded(torch.from_numpy(images))
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **JAX_TOL)
    f64 = parallel.ShardedForward(port_model.double(), mesh=mesh)
    try:
        with torch.no_grad():
            x = torch.from_numpy(images).double()
            for a, b in zip(port_model(x), f64(x)):
                np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                           atol=FORWARD_F64_ATOL)
    finally:
        port_model.float()


@pytest.mark.parametrize('height', [65, 97])
@pytest.mark.parametrize('shards', [2, 3, 4])
def test_narrow_k16_module_graph_on_shards(height, shards):
    """The module graph in float64 against its unsharded forward, H not
    divided by S and empty shards (at 97 over 4 the fields' 7 rows split
    2, 2, 2, 1)."""
    model = _narrow_model().double()
    images = torch.from_numpy(np.random.RandomState(height).randn(
        2, height, 81, 3))
    ref = Predictor(model=model, device='cpu')
    ours = Predictor(model=model, device='cpu', n_devices=shards,
                     spatial_devices=shards)
    with torch.no_grad():
        for a, b in zip(ref._forward(images), ours._forward(images)):
            assert a.shape == b.shape
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                       atol=FORWARD_F64_ATOL)


@pytest.mark.parametrize('engine', ['folded', 'dwpallas', 'pallas'])
@pytest.mark.parametrize('height', [65, 97])
@pytest.mark.parametrize('shards', [2, 3, 4])
def test_engines_on_shards(engine, height, shards):
    """Each engine (its kernels' plain versions on the CPU) on haloed
    shards against the same engine unsharded."""
    model = _narrow_model()
    images = torch.from_numpy(np.random.RandomState(height).randn(
        2, height, 81, 3).astype(np.float32))
    ref = Predictor(model=model, device='cpu', backbone_engine=engine)
    ours = Predictor(model=model, device='cpu', backbone_engine=engine,
                     n_devices=shards, spatial_devices=shards)
    with torch.no_grad():
        for a, b in zip(ref._forward(images), ours._forward(images)):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                       atol=ENGINE_ATOL)


def test_predictor_mesh_serves_shards_on_one_device():
    """``Predictor(mesh=grid_mesh(spatial=S, devices=[d] * S))``, every
    shard on one device, serves what ``n_devices``/``spatial_devices``
    serve; ``devices`` that S does not divide raise as JAX does."""
    model = _narrow_model()
    images = torch.from_numpy(np.random.RandomState(3).randn(
        1, 65, 81, 3).astype(np.float32))
    mesh = parallel.grid_mesh(spatial=2, devices=[torch.device('cpu')] * 2)
    assert isinstance(mesh, parallel.GridMesh) and mesh.shape == (1, 2)
    ours = Predictor(model=model, device='cpu', backbone_engine='pallas',
                     mesh=mesh)
    ref = Predictor(model=model, device='cpu', backbone_engine='pallas',
                    n_devices=2, spatial_devices=2)
    with torch.no_grad():
        for a, b in zip(ref._forward(images), ours._forward(images)):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match='not divisible'):
        parallel.grid_mesh(spatial=3, devices=[torch.device('cpu')] * 2)


def test_zero_rows_above_a_block_are_not_its_halo():
    """The trap the halo exchange avoids: padding a block's input with
    zero rows makes its first 1x1 give relu(b1) where the depthwise reads
    the layer's zero padding. A tile with real neighbours' rows cropped
    after the 'SAME' kernel is exact."""
    folded = fused_inference.fold_shufflenet(_narrow_model().base_net)
    block = folded.blocks[2]  # stage 3's second block
    assert not block.first_in_stage
    weights = shuffle_cuda.block_weights_from_folded(block)
    x = torch.from_numpy(np.random.RandomState(1).randn(
        1, 32, 12, 7).astype(np.float32))

    def run(t):
        return shuffle_cuda.fused_block_plain(t, weights, k=5)

    whole = run(x)
    rows = spatial.Rows.split(x, spatial.SpaceAxis.in_process(2, 'cpu'))
    exact = spatial.gather(spatial.halo_op(rows, 2, lambda k, t: run(t)),
                           'cpu')
    np.testing.assert_allclose(exact.numpy(), whole.numpy(), rtol=0,
                               atol=1e-6)
    # the second shard's rows 6-11 with two zero rows for its halo above
    zero_padded = run(torch.cat([torch.zeros(1, 32, 2, 7), x[:, :, 6:]],
                                dim=2))[:, :, 2:]
    assert (zero_padded - whole[:, :, 6:]).abs().max() > 1e-3


def _jax_train_state(model, variables, loss_fn, optimizer):
    params = jax.tree_util.tree_map(jnp.asarray, variables['params'])
    loss_params = loss_fn.init_params()
    return TrainState(
        params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables['batch_stats']),
        opt_state=optimizer.init({'model': params, 'loss': loss_params}),
        ema_params=jax.tree_util.tree_map(jnp.copy, params),
        step=jnp.zeros((), dtype=jnp.int32),
        loss_params=loss_params,
        loss_state=loss_fn.init_state())


#: the optimizer flags of JAX's spatial step test
JAX_STEP_OPT = dict(momentum=0.9, nesterov=True, lr=1e-3,
                    lr_warm_up_start_epoch=0, lr_warm_up_epochs=1,
                    lr_warm_up_factor=0.001)


def _port_trainer(port_model, spatial_shards, dtype):
    from openpifpaf_tpu_torch.training import losses, optimize
    from openpifpaf_tpu_torch.training.trainer import Trainer
    from torch_port_helpers import optimizer_args
    model = Factory(base_name='resnet18').from_scratch(
        port_metas(16), generator=torch.Generator().manual_seed(0))
    model.load_state_dict(port_model.state_dict())
    optimizer, schedule = optimize.factory_optimizer(
        optimizer_args(**JAX_STEP_OPT), training_batches_per_epoch=1)
    trainer = Trainer(model.to(dtype), losses.Factory().factory(
        port_metas(16)), optimizer, schedule, 'unused', device='cpu',
        spatial=spatial_shards)
    trainer.clip_grad_norm = 1.0
    return trainer


def test_spatial_train_step_parity(resnet18):
    """``test_parallel.py::test_spatial_train_step_parity``: one step on
    the data x space 4 x 2 grid (in one process: the batch whole, each
    image's height over 2 shards) against the data axis, and both against
    JAX's step on its 4 x 2 grid mesh from the same state; then the port's
    sharded step in float64 against its unsharded one (a gradient off by
    the number of shards shows there)."""
    model, variables, port_model = resnet18
    rng = np.random.RandomState(1)
    images = rng.randn(8, 65, 65, 3).astype(np.float32)
    cif_t = rng.rand(8, 17, 5, 5, 5).astype(np.float32)
    caf_t = rng.rand(8, 19, 9, 5, 5).astype(np.float32)

    from torch_port_helpers import optimizer_args
    optimizer, schedule = jax_optimize.factory_optimizer(
        optimizer_args(**JAX_STEP_OPT))
    loss_fn = jax_losses.Factory().factory(
        openpifpaf_tpu.datasets.factory('cocokp').head_metas)
    step = build_train_step(model, loss_fn, optimizer, schedule,
                            clip_grad_norm=1.0,
                            mesh=jax_parallel.grid_mesh(8, spatial=2))
    with jax_f32():
        jax_state, jax_loss, _ = step(
            _jax_train_state(model, variables, loss_fn, optimizer),
            jnp.asarray(images), (jnp.asarray(cif_t), jnp.asarray(caf_t)))
    jax_model = Factory(base_name='resnet18').from_scratch(
        port_metas(16), generator=torch.Generator().manual_seed(0))
    convert_jax.load_jax_variables(jax_model, {
        'params': jax.tree_util.tree_map(np.asarray, jax_state.params),
        'batch_stats': jax.tree_util.tree_map(np.asarray,
                                              jax_state.batch_stats)})
    jax_params = dict(jax_model.named_parameters())

    for dtype, tol in ((torch.float32, None), (torch.float64, STEP_F64_ATOL)):
        batch = [torch.from_numpy(a).to(dtype)
                 for a in (images, cif_t, caf_t)]
        results = {}
        for name, shards in (('dp', 1), ('dpxsp', 2)):
            trainer = _port_trainer(port_model, shards, dtype)
            loss, _ = trainer.train_step(batch[0], tuple(batch[1:]))
            results[name] = float(loss), dict(trainer.model.named_parameters())
        (loss_dp, params_dp), (loss_sp, params_sp) = results['dp'], \
            results['dpxsp']
        if tol is None:
            np.testing.assert_allclose(loss_sp, loss_dp, rtol=LOSS_RTOL)
            np.testing.assert_allclose(loss_dp, float(jax_loss),
                                       rtol=LOSS_RTOL)
            for name, p in params_sp.items():
                np.testing.assert_allclose(
                    p.detach().numpy(), params_dp[name].detach().numpy(),
                    **PARAM_TOL, err_msg=name)
                np.testing.assert_allclose(
                    p.detach().numpy(), jax_params[name].detach().numpy(),
                    **PARAM_TOL, err_msg=name)
            continue
        assert abs(loss_sp - loss_dp) <= tol * abs(loss_dp)
        start = dict(port_model.named_parameters())
        moved = max(float((p.detach().double() - start[n].detach().double())
                          .abs().max())
                    for n, p in params_dp.items())
        assert moved > 1e3 * tol
        for name, p in params_sp.items():
            np.testing.assert_allclose(
                p.detach().numpy(), params_dp[name].detach().numpy(),
                rtol=0, atol=tol, err_msg=name)


def test_predictor_spatial_devices_parity(resnet18):
    """``test_parallel.py::test_predictor_spatial_devices_parity``:
    ``n_devices=8``, ``spatial_devices=4`` against JAX's unsharded
    Predictor forward and the port's."""
    model, variables, port_model = resnet18
    images = np.random.RandomState(5).randn(2, 65, 65, 3).astype(np.float32)
    p_ref = JaxPredictor(model=model, variables=variables)
    p_ref.size_bucket = 0
    with jax_f32():
        ref = p_ref.forward_fn(variables, images)
    ours = Predictor(model=port_model, device='cpu', n_devices=8,
                     spatial_devices=4)
    assert ours.spatial_devices == 4
    unsharded = Predictor(model=port_model, device='cpu')
    with torch.no_grad():
        out = ours._forward(torch.from_numpy(images))
        plain = unsharded._forward(torch.from_numpy(images))
    for r, o, u in zip(ref, out, plain):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **JAX_TOL)
        np.testing.assert_allclose(o.numpy(), u.numpy(), rtol=0,
                                   atol=ENGINE_ATOL)


def _free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    env.pop('JAX_PLATFORMS', None)
    return env


@pytest.fixture(scope='module')
def two_ranks(tmp_path_factory, resnet18):
    """The batch, the start state and the results of two gloo ranks of
    ``torch_spatial_worker.py`` (data 1 x space 2)."""
    workdir = tmp_path_factory.mktemp('spatial')
    rng = np.random.RandomState(42)
    batch = dict(images=rng.randn(2, 65, 65, 3).astype(np.float32),
                 cif=(0.1 * rng.randn(2, 17, 5, 5, 5)).astype(np.float32),
                 caf=(0.1 * rng.randn(2, 19, 9, 5, 5)).astype(np.float32))
    np.savez(workdir / 'batch.npz', **batch)
    start = {k: v.clone() for k, v in resnet18[2].state_dict().items()}
    torch.save(start, workdir / 'start.pt')
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, 'torch_spatial_worker.py'),
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
    return batch, start, ranks


def test_exchange_remote_side_gradcheck(two_ranks):
    """The remote side under two gloo ranks: ``gradcheck`` passes on both,
    and its tiles equal the local side's."""
    _, _, ranks = two_ranks
    assert [r['gradcheck'] for r in ranks] == [True, True]
    x = torch.from_numpy(np.random.RandomState(3).randn(
        *torch_spatial_worker.CHECK_SHAPE))
    local = torch_spatial_worker.exchanged_tiles(
        x, spatial.SpaceAxis.in_process(2, 'cpu'))
    for r in ranks:
        torch.testing.assert_close(r['tiles'], local, rtol=0, atol=0)


def test_two_process_spatial_mesh_matches_single_process(two_ranks):
    """``test_multihost.py::test_two_process_spatial_mesh_matches_single_
    process``: the ranks' losses and parameters are equal, and within rel
    1e-4 of the one-process grid mesh."""
    batch, start, ranks = two_ranks
    assert ranks[0]['history'] == ranks[1]['history']
    assert ranks[0]['checksum'] == ranks[1]['checksum']
    single = torch_spatial_worker.build_trainer(start, spatial=2)
    history = torch_spatial_worker.train(single, batch)
    np.testing.assert_allclose(ranks[0]['history'], history,
                               rtol=RANKS_RTOL)
    assert ranks[0]['history'][1] != ranks[0]['history'][0]
    np.testing.assert_allclose(
        ranks[0]['checksum'],
        torch_spatial_worker.checksum(single.model.state_dict()),
        rtol=RANKS_RTOL)


def test_train_cli_spawns_spatial_ranks(tmp_path):
    """``train --device cpu --n-devices 4 --batch-size 1
    --spatial-partitions 2``: JAX's rule shrinks the mesh to
    max(2, 1 x 2) = 2 ranks, which split each image's height."""
    ann_file, image_dir = write_synthetic_coco(
        str(tmp_path / 'coco'), n_images=2, image_hw=(97, 129), seed=3)
    out = str(tmp_path / 'model')
    done = subprocess.run(
        [sys.executable, '-m', 'openpifpaf_tpu_torch.train',
         '--dataset', 'cocokp', '--cocokp-train-annotations', ann_file,
         '--cocokp-val-annotations', ann_file,
         '--cocokp-train-image-dir', image_dir,
         '--cocokp-val-image-dir', image_dir,
         '--cocokp-square-edge', '65', '--cocokp-no-augmentation',
         '--batch-size', '1', '--epochs', '1', '--train-batches', '1',
         '--val-batches', '1', '--device', 'cpu', '--n-devices', '4',
         '--spatial-partitions', '2', '--output', out],
        env=_env(), capture_output=True, text=True, timeout=WORKER_TIMEOUT)
    assert done.returncode == 0, done.stderr[-3000:]
    assert 'shrinking the data mesh' in done.stdout + done.stderr
    assert 'spawning 2 ranks' in done.stdout
    assert os.path.exists(out + '.pt')
    with open(out + '.log') as f:
        lines = f.read().splitlines()
    assert sum('"train-epoch"' in line for line in lines) == 1
