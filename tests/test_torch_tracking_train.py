"""Tracking training of the PyTorch port against the JAX package: the Tcaf
encoder, the pair transforms, the cocokpst and posetrack2018 train
pipelines, the tracking losses, the TrackingShell train step and the
posetrack data modules' readers.

Tolerances:
- the Tcaf encoder equals the ``tcaf_0`` golden bit for bit;
- the pair transforms and the train loaders give bit-equal batches
  (images, targets with NaN where NaN, metas, order) from the same seeded
  global ``np.random``, with augmentation on and no loader workers;
- the loss of the cocokpst heads on the same outputs and targets: the
  total rtol 1e-5, each component rtol 1e-5 (the same float32 reductions
  in two frameworks);
- three steps of a narrow tracking shell: the losses and each head's
  components, the parameters, BatchNorm buffers and EMA as
  ``test_torch_train_trainer.py`` holds the cocokp step;
- a ``--bf16`` step of the tracking shell: its losses within 2e-3 of the
  float32 step's total (the bound of ``test_torch_train_trainer.py``).
"""

import copy
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

import openpifpaf_tpu
from openpifpaf_tpu import transforms as jax_transforms
from openpifpaf_tpu.models.shell import assign_strides as jax_assign_strides
from openpifpaf_tpu.plugins.coco.cocokp import CocoKp as JaxCocoKp
from openpifpaf_tpu.plugins.posetrack import benchmark as jax_benchmark
from openpifpaf_tpu.plugins.posetrack import normalize as jax_normalize
from openpifpaf_tpu.plugins.posetrack.datasets import \
    Posetrack2018 as JaxPosetrack2018Dataset
from openpifpaf_tpu.plugins.posetrack.posetrack2017 import \
    Posetrack2017 as JaxPosetrack2017
from openpifpaf_tpu.plugins.posetrack.posetrack2018 import \
    Posetrack2018 as JaxPosetrack2018
from openpifpaf_tpu.signal_ import Signal as JaxSignal
from openpifpaf_tpu.training import losses as jax_losses
from openpifpaf_tpu.training import optimize as jax_optimize
from openpifpaf_tpu.training.trainer import TrainState, build_train_step
from openpifpaf_tpu_torch import datasets, encoder, headmeta, train, \
    transforms
from openpifpaf_tpu_torch.datasets import LoaderWithReset
from openpifpaf_tpu_torch.models import convert_jax
from openpifpaf_tpu_torch.models.shell import assign_strides
from openpifpaf_tpu_torch.models.tracking import TrackingShell
from openpifpaf_tpu_torch.plugins.coco import constants
from openpifpaf_tpu_torch.plugins.coco.cocokp import CocoKp
from openpifpaf_tpu_torch.plugins.posetrack import benchmark, normalize
from openpifpaf_tpu_torch.plugins.posetrack.datasets import \
    Posetrack2018 as Posetrack2018Dataset
from openpifpaf_tpu_torch.plugins.posetrack.posetrack2017 import \
    Posetrack2017
from openpifpaf_tpu_torch.plugins.posetrack.posetrack2018 import \
    Posetrack2018
from openpifpaf_tpu_torch.signal_ import Signal
from openpifpaf_tpu_torch.training import checkpoint, losses, optimize
from openpifpaf_tpu_torch.training.trainer import Trainer

import field_fixtures
from test_torch_train_trainer import OPT, assert_history_close, \
    assert_state_close
from torch_port_helpers import jax_f32, jax_narrow_tracking_shell, \
    numpy_variables, one_torch_thread, optimizer_args, port_narrow_shell, \
    restored_statics, write_synthetic_coco, write_synthetic_posetrack2018

SEED = 7
STRIDE = 16
EDGE = 97
LOSS_RTOL = 1e-5
BF16_RTOL = 2e-3
N_STEPS = 3


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    one_torch_thread()


@pytest.fixture(scope='module')
def coco(tmp_path_factory):
    return write_synthetic_coco(str(tmp_path_factory.mktemp('coco')),
                                n_images=8, image_hw=(113, 129), seed=1)


@pytest.fixture(scope='module')
def posetrack(tmp_path_factory):
    return write_synthetic_posetrack2018(
        str(tmp_path_factory.mktemp('posetrack')), n_sequences=2,
        n_frames=4, image_hw=(129, 225), seed=2)


# -- the Tcaf encoder ----------------------------------------------------------

def test_tcaf_encoder_matches_golden():
    """The scene of ``tools/capture_encoder_golden.py``'s ``tcaf_0``: two
    tracks that move between the frames (one loses joints) and a crowd
    box in frame 1."""
    golden = np.load(os.path.join(os.path.dirname(os.path.abspath(
        __file__)), 'golden', 'encoder_golden.npz'))['tcaf_0']
    meta = headmeta.Tcaf(
        'tcaf', 'test',
        keypoints_single_frame=constants.COCO_KEYPOINTS,
        sigmas_single_frame=constants.COCO_PERSON_SIGMAS,
        pose_single_frame=constants.COCO_UPRIGHT_POSE,
        draw_skeleton_single_frame=constants.COCO_PERSON_SKELETON)
    meta.base_stride = 8
    rng = np.random.RandomState(7)

    def person(cx, cy, height):
        return field_fixtures.synthetic_person(cx, cy, height, rng)

    def ann(kps, iscrowd=False, track_id=None, bbox=None):
        if bbox is None:
            xs, ys = kps[kps[:, 2] > 0, 0], kps[kps[:, 2] > 0, 1]
            bbox = np.array([xs.min(), ys.min(), xs.max() - xs.min(),
                             ys.max() - ys.min()], dtype=np.float32)
        return {'keypoints': kps, 'bbox': bbox, 'iscrowd': iscrowd,
                **({'track_id': track_id} if track_id is not None else {})}

    q1, q2 = person(120, 100, 140), person(220, 120, 130)
    q1b, q2b = q1.copy(), q2.copy()
    q1b[:, 0] += 6.0
    q2b[:, 1] += 4.0
    q2b[5:9, 2] = 0.0
    frame1 = [ann(q1, track_id=1), ann(q2, track_id=2),
              ann(np.zeros((17, 3), dtype=np.float32), iscrowd=True,
                  bbox=np.array([5., 5., 50., 30.], dtype=np.float32))]
    frame2 = [ann(q1b, track_id=1), ann(q2b, track_id=2)]
    image = np.zeros((241, 321, 3), dtype=np.float32)
    out = encoder.Tcaf(meta)([image, image], (frame1, frame2), {})
    assert isinstance(out, np.ndarray) and out.shape == golden.shape
    assert out.dtype == golden.dtype
    np.testing.assert_array_equal(out, golden)
    assert (out[:, 0] == 1.0).any()


# -- the pair transforms -----------------------------------------------------

def _group(seed):
    """A pair group as the posetrack reader gives it: two 65x81 PIL frames,
    two people with track ids and a crowd region per frame, fresh metas."""
    rng = np.random.RandomState(seed)
    images, anns, metas = [], [], []
    for group_i in range(2):
        images.append(PIL.Image.fromarray(
            rng.randint(0, 256, (65, 81, 3)).astype(np.uint8)))
        frame = []
        for track_id in range(2):
            kps = field_fixtures.synthetic_person(
                20.0 + 35.0 * track_id + 2.0 * group_i, 32.0, 40.0, rng)
            frame.append({'keypoints': kps, 'track_id': track_id,
                          'bbox': np.array([kps[:, 0].min(), kps[:, 1].min(),
                                            10.0, 40.0], np.float32),
                          'iscrowd': False})
        frame.append({'keypoints': np.zeros((4, 3), np.float32),
                      'bbox': np.array([1.0, 1.0, 8.0, 6.0], np.float32),
                      'iscrowd': True, 'track_id': -1})
        anns.append(frame)
        metas.append({'dataset_index': seed, 'image_id': group_i,
                      'group_i': group_i})
    return images, anns, metas


def _normalized(package, seed):
    images, anns, metas = _group(seed)
    return package.pair.SingleImage(package.NormalizeAnnotations())(
        images, anns, metas)


#: name -> (factory of the transform given its package, whether it takes
#: a whole group (else one frame, the way the pipelines wrap it))
PAIR_TRANSFORMS = {
    'single_image_rescale': (lambda t: t.pair.SingleImage(t.RescaleRelative(
        scale_range=(0.5, 1.5), power_law=True,
        stretch_range=(0.75, 1.33))), True),
    'camera_shift': (lambda t: t.pair.SingleImage(
        t.pair.CameraShift(max_shift=7)), True),
    'crop': (lambda t: t.pair.Crop(49, max_shift=5.0), True),
    'crop_no_interest': (lambda t: t.pair.Crop(
        49, use_area_of_interest=False), True),
    'pad': (lambda t: t.pair.Pad(97, max_shift=6.0), True),
    'blank_past': (lambda t: t.pair.BlankPast(), True),
    'previous_past': (lambda t: t.pair.PreviousPast(), True),
    'randomize_one_frame': (lambda t: t.pair.RandomizeOneFrame(), True),
    'sample_pairing': (lambda t: t.pair.SamplePairing(), True),
    'image_to_tracking': (lambda t: t.pair.ImageToTracking(), False),
}


def _plain(x):
    """Nested dicts and lists of arrays (PIL images as arrays), for
    ``np.testing.assert_equal``."""
    if isinstance(x, PIL.Image.Image):
        return np.asarray(x)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


@pytest.mark.parametrize('name', sorted(PAIR_TRANSFORMS))
def test_pair_transform_matches_jax(name):
    """Three groups through each pair transform (the stateful ones carry
    their state from group to group), with the global ``np.random``
    seeded alike: equal frames, annotations and metas."""
    build, takes_group = PAIR_TRANSFORMS[name]
    results = []
    for package in (transforms, jax_transforms):
        transform = build(package)
        np.random.seed(SEED)
        out = []
        for seed in range(3):
            group = _normalized(package, seed)
            if not takes_group:
                group = (group[0][0], group[1][0], group[2][0])
            out.append(_plain(transform(*group)))
        results.append(out)
    ours, ref = results
    for o, r in zip(ours, ref):
        np.testing.assert_equal(o, r)


# -- the train loaders -------------------------------------------------------

#: (data module, configuration): the class settings of the configuration
#: (CocoKp's for cocokpst, Posetrack2018's for posetrack2018)
LOADER_CONFIGS = {
    ('cocokpst', 'default'): {},
    ('cocokpst', 'with_dense'): {'with_dense': True},
    ('posetrack2018', 'default'): {},
    ('posetrack2018', 'with_dense_sample_pairing'): {
        'with_dense': True, 'sample_pairing': 0.5, 'image_aug': 0.5},
}


def _train_batches(dataset, package, coco, posetrack, config, epochs=2):
    cocokp_cls, posetrack_cls, factory, assign = package
    with restored_statics(cocokp_cls, posetrack_cls):
        if dataset == 'cocokpst':
            ann_file, image_dir = coco
            cocokp_cls.train_annotations = ann_file
            cocokp_cls.train_image_dir = image_dir
            cocokp_cls.square_edge = EDGE
            settings_cls = cocokp_cls
        else:
            train_glob, _, root = posetrack
            posetrack_cls.train_annotations = train_glob
            posetrack_cls.data_root = root
            posetrack_cls.square_edge = EDGE
            settings_cls = posetrack_cls
        for k, v in config.items():
            setattr(settings_cls, k, v)
        datamodule = factory(dataset)
        datamodule.batch_size = 4
        assign(datamodule.head_metas, STRIDE)
        loader = datamodule.train_loader()
        np.random.seed(SEED)
        out = []
        for epoch in range(epochs):
            loader.set_epoch(epoch)
            out.extend(loader)
        return out


PORT = (CocoKp, Posetrack2018, datasets.factory, assign_strides)
JAX = (JaxCocoKp, JaxPosetrack2018, openpifpaf_tpu.datasets.factory,
       jax_assign_strides)


def _comparable_meta(meta):
    meta = dict(meta)
    swap = meta.pop('horizontal_swap', None)
    if swap is not None:
        meta['horizontal_swap'] = swap.permutation.tolist()
    return meta


@pytest.mark.parametrize('dataset,config', sorted(LOADER_CONFIGS))
def test_train_batches_equal_jax(coco, posetrack, dataset, config):
    """Two epochs of pairs, 2 per batch: interleaved (4, 97, 97, 3) frames,
    the CIF/CAF(/dense CAF)/Tcaf targets per pair, one meta per pair."""
    kw = LOADER_CONFIGS[dataset, config]
    ours = _train_batches(dataset, PORT, coco, posetrack, kw)
    ref = _train_batches(dataset, JAX, coco, posetrack, kw)
    # 8 COCO images, or 2 sequences of 4 frames = 6 pairs (0, -1)
    assert len(ours) == len(ref) == (8 if dataset == 'cocokpst' else 6)
    n_heads = 4 if kw.get('with_dense') else 3
    tcaf_painted = 0
    for (images, targets, metas), (r_images, r_targets, r_metas) in zip(
            ours, ref):
        assert images.shape == (4, EDGE, EDGE, 3)
        assert images.dtype == np.float32
        np.testing.assert_array_equal(images, r_images)
        assert len(targets) == len(r_targets) == n_heads
        for t, r in zip(targets, r_targets):
            assert t.shape[0] == 2 and t.shape == r.shape
            assert t.dtype == r.dtype
            np.testing.assert_array_equal(t, r)
        tcaf_painted += int((targets[-1][:, :, 0] == 1.0).any())
        assert len(metas) == len(r_metas) == 2
        for m, r in zip(metas, r_metas):
            m, r = _comparable_meta(m), _comparable_meta(r)
            assert sorted(m) == sorted(r)
            assert m['head_indices'] == list(range(n_heads))
            for key in m:
                np.testing.assert_equal(m[key], r[key], err_msg=key)
    assert tcaf_painted > 0


def test_cocokpst_loader(coco):
    """Port of ``tests/test_tracking.py::test_cocokpst_loader`` over a
    synthetic COCO set: one pair gives an interleaved batch of 2 frames
    and the cif, caf and tcaf targets."""
    ann_file, image_dir = coco
    with restored_statics(CocoKp):
        CocoKp.train_annotations = ann_file
        CocoKp.train_image_dir = image_dir
        datamodule = datasets.factory('cocokpst')
        for i, m in enumerate(datamodule.head_metas):
            m.head_index = i
            m.base_stride = 16
        datamodule.batch_size = 2
        images, targets, metas = next(iter(datamodule.train_loader()))
    assert images.shape[0] == 2
    assert len(targets) == 3
    assert targets[0].shape[1:3] == (17, 5)
    assert targets[2].shape[1:3] == (17, 9)
    assert len(metas) == 1


# -- the losses --------------------------------------------------------------

@pytest.fixture(scope='module')
def pair_batch(coco):
    """(frames (4, 97, 97, 3), targets) of the port's cocokpst pipeline,
    augmentation on."""
    return _train_batches('cocokpst', PORT, coco, None, {}, epochs=1)[0][:2]


@pytest.fixture(scope='module')
def jax_variables():
    model = jax_narrow_tracking_shell(
        openpifpaf_tpu.datasets.factory('cocokpst').head_metas)
    return numpy_variables(jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((2, 65, 65, 3)),
                           train=True)), seed=11)


def _port_shell(variables):
    model = port_narrow_shell(datasets.factory('cocokpst').head_metas)
    convert_jax.load_jax_variables(model, variables)
    return model


def test_loss_factory_builds_for_cocokpst_and_matches_jax(pair_batch,
                                                          jax_variables):
    """Repair: the loss factory knows the tracking metas (it raised
    ``KeyError`` on ``TSingleImageCif``). On a narrow tracking shell's
    train-mode fields of a cocokpst batch, the total and every component
    equal JAX's."""
    ours = losses.Factory().factory(datasets.factory('cocokpst').head_metas)
    ref = jax_losses.Factory().factory(
        openpifpaf_tpu.datasets.factory('cocokpst').head_metas)
    assert ours.field_names == ref.field_names
    assert [type(l).__name__ for l in ours.losses] == ['CompositeLoss'] * 3
    images, targets = pair_batch
    with torch.no_grad():
        outputs = _port_shell(jax_variables)(torch.from_numpy(images),
                                             train=True)
    # raw train-mode outputs: CIF 5 channels, CAF and Tcaf 8
    assert [tuple(o.shape[:3]) for o in outputs] == [
        (2, 17, 5), (2, 19, 8), (2, 17, 8)]
    total, flat, _ = ours(outputs, tuple(torch.from_numpy(t)
                                         for t in targets))
    with jax_f32():
        ref_total, ref_flat, _ = ref(
            tuple(jnp.asarray(o.numpy()) for o in outputs),
            tuple(jnp.asarray(t) for t in targets))
    assert np.isfinite(float(total))
    np.testing.assert_allclose(float(total), float(ref_total),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose([float(l) for l in flat],
                               [float(l) for l in ref_flat], rtol=LOSS_RTOL)


# -- the train step ----------------------------------------------------------

def _run_jax(variables, batch):
    metas = openpifpaf_tpu.datasets.factory('cocokpst').head_metas
    model = jax_narrow_tracking_shell(metas)
    loss_fn = jax_losses.Factory().factory(metas)
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
    images, targets = batch
    history = []
    with jax_f32():
        for _ in range(N_STEPS):
            state, loss, head_losses = step(
                state, jnp.asarray(images),
                tuple(jnp.asarray(t) for t in targets))
            history.append((float(loss), [float(l) for l in head_losses]))
    return history, state


def _port_trainer(variables, **attrs):
    model = _port_shell(variables)
    optimizer, schedule = optimize.factory_optimizer(
        optimizer_args(**OPT), training_batches_per_epoch=1)
    trainer = Trainer(model, losses.Factory().factory(
        datasets.factory('cocokpst').head_metas), optimizer, schedule,
        'unused', device='cpu')
    for k, v in attrs.items():
        setattr(trainer, k, v)
    return trainer


def _run_port(trainer, batch, n_steps=N_STEPS):
    images, targets = batch
    images = torch.from_numpy(images)
    targets = tuple(torch.from_numpy(t) for t in targets)
    return [(float(loss), [float(l) for l in head_losses])
            for loss, head_losses in (trainer.train_step(images, targets)
                                      for _ in range(n_steps))]


def test_three_tracking_steps_match_jax(pair_batch, jax_variables):
    """Three steps of the narrow tracking shell on an interleaved batch of
    two pairs: BatchNorm over the 4 frames, the single-image heads on the
    primary frames, Tcaf on the pairs. Losses per component after each
    step, then the parameters, BatchNorm buffers and EMA."""
    ref, state = _run_jax(jax_variables, pair_batch)
    trainer = _port_trainer(jax_variables)
    assert isinstance(trainer.model, TrackingShell)
    ours = _run_port(trainer, pair_batch)
    assert len(ours[0][1]) == 9  # c, vec, scales of cif, caf and tcaf
    assert_history_close(ours, ref)
    assert trainer.step == int(state.step) == N_STEPS
    assert_state_close(trainer, state,
                       convert_jax.state_dict_from_jax(jax_variables))


def test_bf16_tracking_step_near_float32(pair_batch, jax_variables):
    """``--bf16`` is allowed for training a tracking model (serving raises):
    the backbone runs under bfloat16 autocast on all 4 frames, the heads
    in float32 on the pairs; its losses are within 2e-3 of the float32
    step's total."""
    f32 = _run_port(_port_trainer(jax_variables), pair_batch, n_steps=1)
    b16 = _run_port(_port_trainer(jax_variables, bf16=True), pair_batch,
                    n_steps=1)
    (loss, heads), = b16
    (ref_loss, ref_heads), = f32
    assert np.isfinite(loss) and np.all(np.isfinite(heads))
    np.testing.assert_allclose(loss, ref_loss, rtol=0,
                               atol=BF16_RTOL * abs(ref_loss))
    np.testing.assert_allclose(heads, ref_heads, rtol=0,
                               atol=BF16_RTOL * abs(ref_loss))


def test_train_cli_trains_cocokpst(coco, tmp_path, caplog):
    """``train --dataset cocokpst --basenet tshufflenetv2k16`` on the CPU
    (the repair: it raised ``KeyError``): two steps of pairs, a val pass,
    the checkpoints written, and ``load_shell`` reads a TrackingShell."""
    ann_file, image_dir = coco
    out = str(tmp_path / 'model')
    caplog.set_level(logging.INFO)  # the trainer's lines reach the log
    with restored_statics(CocoKp):
        trainer = train.main([
            '--dataset', 'cocokpst', '--basenet', 'tshufflenetv2k16',
            '--cocokp-train-annotations', ann_file,
            '--cocokp-val-annotations', ann_file,
            '--cocokp-train-image-dir', image_dir,
            '--cocokp-val-image-dir', image_dir,
            '--cocokp-square-edge', '65', '--batch-size', '4',
            '--epochs', '1', '--train-batches', '2', '--val-batches', '1',
            '--log-interval', '1', '--device', 'cpu', '--output', out])
    assert isinstance(trainer.model, TrackingShell)
    with open(out + '.log') as f:
        lines = [json.loads(line) for line in f]
    steps = [line for line in lines if line.get('type') == 'train']
    val = [line for line in lines if line.get('type') == 'val-epoch']
    assert len(steps) == 2 and len(val) == 1
    assert all(len(line['head_losses']) == 9 for line in steps + val)
    assert np.all(np.isfinite([line['loss'] for line in steps + val]))
    model, meta = checkpoint.load_shell(out)
    assert isinstance(model, TrackingShell)
    assert meta['base_name'] == 'tshufflenetv2k16'
    assert [type(m).__name__ for m in model.head_metas] == [
        'TSingleImageCif', 'TSingleImageCaf', 'Tcaf']
    for name, value in model.state_dict().items():
        assert torch.equal(value, trainer.ema_state_dict()[name]), name


# -- the posetrack readers and LoaderWithReset -------------------------------

def test_loader_with_reset_signal():
    """Port of ``tests/test_tracking.py::test_loader_with_reset_signal``:
    one ``eval_reset`` when the monitored key changes, emitted as the
    consumer pulls the first batch of the new value."""
    batches = [
        ('im0', [], [{'video_id': 'a'}]),
        ('im1', [], [{'video_id': 'a'}]),
        ('im2', [], [{'video_id': 'b'}]),
        ('im3', [], [{'video_id': 'b'}]),
    ]
    resets = []
    saved = dict(Signal.subscribers)
    Signal.subscribers = {'eval_reset': [lambda: resets.append(len(seen))]}
    try:
        wrapped = LoaderWithReset(batches, 'video_id')
        assert len(wrapped) == 4
        seen = []
        for b in wrapped:
            seen.append(b[0])
    finally:
        Signal.subscribers = saved
    assert seen == ['im0', 'im1', 'im2', 'im3']
    # after im0 and im1 were consumed, before im2 was
    assert resets == [2]


def _write_posetrack2017(tmp_path):
    img_dir = tmp_path / 'images'
    img_dir.mkdir()
    names = []
    for i in range(3):
        name = f'images/frame_{i:04d}.jpg'
        PIL.Image.new('RGB', (65, 49), (i * 40, 0, 0)).save(tmp_path / name)
        names.append(name)
    ann = {'annolist': [
        {'image': [{'name': n}], 'annorect': []} for n in names
    ]}
    with open(tmp_path / 'seq1.json', 'w') as f:
        json.dump(ann, f)


def _posetrack2017_batches(module_cls, tmp_path):
    with restored_statics(module_cls):
        module_cls.eval_annotations = str(tmp_path / '*.json')
        module_cls.data_root = str(tmp_path)
        dm = module_cls()
        assert len(dm.head_metas) == 3  # cif, caf, tcaf
        dm.batch_size = 1
        dm.loader_workers = 0
        batches = list(dm.eval_loader())
        metric, = dm.metrics()
    return batches, metric


def test_posetrack2017_eval_loader(tmp_path):
    """Port of ``tests/test_tracking.py::test_posetrack2017_eval_loader``
    on the same annolist sequence, and its batches equal JAX's."""
    _write_posetrack2017(tmp_path)
    batches, metric = _posetrack2017_batches(Posetrack2017, tmp_path)
    assert len(batches) == 3
    images, anns, metas = batches[0]
    assert metas[0]['annotation_file'].endswith('seq1.json')
    assert images[0].shape[-1] == 3
    assert metric.output_format == '2017'
    ref, _ = _posetrack2017_batches(JaxPosetrack2017, tmp_path)
    np.testing.assert_equal(batches, ref)


def _write_posetrack2018_frame(tmp_path):
    (tmp_path / 'images').mkdir()
    PIL.Image.new('RGB', (65, 49)).save(tmp_path / 'images' / 'f0.jpg')
    ann = {
        'images': [{
            'frame_id': 0, 'file_name': 'images/f0.jpg', 'id': 0,
            'ignore_regions_x': [[1, 10, 10, 1]],
            'ignore_regions_y': [[1, 1, 10, 10]],
        }],
        'annotations': [{
            'image_id': 0, 'track_id': 0,
            'bbox': [0, 0, 30, 30],
            'keypoints': ([20.0, 20.0, 1.0] + [200.0, 20.0, 1.0]
                          + [0.0, 0.0, 0.0] * 15),
        }],
    }
    with open(tmp_path / 'seq.json', 'w') as f:
        json.dump(ann, f)
    return ann


def test_posetrack2018_normalization(tmp_path):
    """Port of ``tests/test_tracking.py::test_posetrack2018_normalization``:
    ignore regions become crowd annotations, v=1 keypoints visible,
    out-of-frame keypoints zeroed; the sample equals JAX's."""
    _write_posetrack2018_frame(tmp_path)
    samples = [cls(str(tmp_path / '*.json'), str(tmp_path),
                   preprocess=lambda i, a, m: (i, a, m), group=(0,))[0]
               for cls in (Posetrack2018Dataset, JaxPosetrack2018Dataset)]
    _, anns, _ = samples[0]
    frame_anns = anns[0]
    person = [a for a in frame_anns if not a['iscrowd']][0]
    crowd = [a for a in frame_anns if a['iscrowd']]
    assert len(crowd) == 1  # from the ignore region
    assert crowd[0]['bbox'][2] == 9
    assert person['keypoints'][0, 2] == 2.0  # v=1 -> visible
    assert person['keypoints'][1, 2] == 0.0  # x=200 out of 65-px frame
    np.testing.assert_equal(_plain(samples[0]), _plain(samples[1]))


def test_normalize_transforms_match_jax(tmp_path):
    """``NormalizePosetrack`` on a raw frame record and ``NormalizeMOT`` on
    MOT-style annotations equal JAX's."""
    raw = _write_posetrack2018_frame(tmp_path)
    frame = {'image': raw['images'][0], 'annotations': [
        dict(raw['annotations'][0],
             keypoints=[20.0, 20.0, 1.0] + [0.0, 0.0, 0.0] * 16)]}
    image = PIL.Image.new('RGB', (65, 49))
    mot = [{'keypoints': [1.0, 2.0, 1.0] * 17, 'bbox': [1, 2, 3, 4],
            'segmentation': [], 'track_id': 3}]
    for ours, ref, anns in (
            (normalize.NormalizePosetrack(),
             jax_normalize.NormalizePosetrack(), frame),
            (normalize.NormalizePosetrack(ignore_missing_bbox=True,
                                          fix_annotations=False),
             jax_normalize.NormalizePosetrack(ignore_missing_bbox=True,
                                              fix_annotations=False), frame),
            (normalize.NormalizeMOT(), jax_normalize.NormalizeMOT(), mot)):
        _, o_anns, o_meta = ours(image, copy.deepcopy(anns))
        _, r_anns, r_meta = ref(image, copy.deepcopy(anns))
        np.testing.assert_equal((o_anns, o_meta), (r_anns, r_meta))
        assert any(a.get('iscrowd') for a in o_anns) == (anns is frame)


def test_posetrack2018_eval_loader_resets_between_sequences(posetrack):
    """The posetrack2018 eval loader: single frames (batch 1) in sequence
    order, ``eval_reset`` emitted once, as the first frame of the second
    sequence is pulled; the batches equal JAX's."""
    _, val_glob, root = posetrack
    out = []
    for module_cls, signal in ((Posetrack2018, Signal),
                               (JaxPosetrack2018, JaxSignal)):
        saved = dict(signal.subscribers)
        log = []
        signal.subscribers = {'eval_reset': [lambda: log.append('reset')]}
        try:
            with restored_statics(module_cls):
                module_cls.eval_annotations = val_glob
                module_cls.data_root = root
                module_cls.eval_long_edge = 129
                dm = module_cls()
                dm.batch_size = 1
                for images, anns, metas in dm.eval_loader():
                    log.append((images, [[(type(a).__name__, vars(a))
                                          for a in frame] for frame in anns],
                                metas))
        finally:
            signal.subscribers = saved
        out.append(log)
    ours, ref = out
    assert [e == 'reset' for e in ours] == [False] * 4 + [True] + \
        [False] * 4
    files = [e[2][0]['annotation_file'] for e in ours if e != 'reset']
    assert files[0] == files[3] != files[4] == files[7]
    assert ours[0][0].shape == (1, 81, 129, 3)
    assert len(ours[0][1][0]) == 4  # 3 people and the ignore region
    np.testing.assert_equal(_plain(ours), _plain(ref))


def test_posetrack_data_modules_registered():
    names = sorted(datasets.datamodules())
    assert names == ['animal', 'apollo', 'cifar10', 'cocodet', 'cocokp',
                     'cocokpst', 'crowdpose', 'nuscenes', 'posetrack2017',
                     'posetrack2018', 'wholebody']
    for name in ('posetrack2018', 'posetrack2017'):
        ours = datasets.factory(name).head_metas
        ref = openpifpaf_tpu.datasets.factory(name).head_metas
        assert [type(m).__name__ for m in ours] == \
            [type(m).__name__ for m in ref]
        assert [(m.name, m.dataset, len(m.keypoints)) for m in ours] == \
            [(m.name, m.dataset, len(m.keypoints)) for m in ref]
    with pytest.raises(NotImplementedError, match='train on posetrack2018'):
        datasets.factory('posetrack2017').train_loader()


# -- the tracking benchmark wrapper ------------------------------------------

def test_benchmark_ablations_match_jax(monkeypatch):
    """Every ablation suite passes the JAX wrapper's eval flags, each one a
    flag of the port's eval CLI; an eval flag the wrapper does not know,
    ``--device cpu``, reaches every eval; ``--crowdpose`` evaluates
    crowdpose with JAX's eval flags and its three ``--crowdpose-index``
    buckets."""
    import argparse
    from openpifpaf_tpu_torch import decoder
    argv = ['--checkpoints', 'a', '--ablation-1', '--ablation-2',
            '--ablation-3', '--ablation-4', '--ablation-5']
    monkeypatch.setattr('sys.argv', ['benchmark'] + argv)
    args, eval_args, dataset = benchmark.cli(argv)
    r_args, r_eval_args, r_dataset = jax_benchmark.cli()
    assert dataset == r_dataset == 'posetrack2018'
    ours = benchmark.ablation_list(args, eval_args)
    ref = jax_benchmark.ablation_list(r_args, r_eval_args)
    assert ours == ref and len(ours) == 13
    parser = argparse.ArgumentParser()
    with restored_statics(*decoder.DECODERS, decoder.TrackBase):
        decoder.cli(parser)
        for dm in datasets.datamodules().values():
            dm.cli(parser)
        parser.add_argument('--loader-workers')
        parser.add_argument('--write-predictions', action='store_true')
        for _, flags in ours:
            parser.parse_args(flags)
    args, eval_args, _ = benchmark.cli([*argv, '--device', 'cpu'])
    assert all(flags[flags.index('--device') + 1] == 'cpu'
               for _, flags in benchmark.ablation_list(args, eval_args))
    argv = ['--checkpoints', 'a', '--crowdpose']
    monkeypatch.setattr('sys.argv', ['benchmark'] + argv)
    args, eval_args, dataset = benchmark.cli(argv)
    r_args, r_eval_args, r_dataset = jax_benchmark.cli()
    assert dataset == r_dataset == 'crowdpose'
    assert eval_args == r_eval_args
    assert {'--force-complete-pose', '--seed-threshold=0.2',
            '--decoder=cifcaf:0'} <= set(eval_args)
    ours = benchmark.ablation_list(args, eval_args)
    assert ours == jax_benchmark.ablation_list(r_args, r_eval_args)
    assert [suffix for suffix, _ in ours] == ['', '.easy', '.medium', '.hard']
    for _, flags in ours:
        parser.parse_args(flags)
