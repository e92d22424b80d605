"""Wholebody-133 of the PyTorch port against the JAX package: the first hold
of the port's decode at 133 keypoints, the encoders at 133 CIF fields and
160 CAF edges, the ``KpDataModule`` pipelines (wholebody and crowdpose),
``WholeBodyMetric``, one train step and the checkpoint's metas.

Tolerances:
- the decode: the port's ``CifCaf`` on the contested scenes of
  ``test_wholebody_parity.py`` (seeds 0 and 1, 137x177, stride 8; one
  module-scoped JAX decoder) against JAX's ``CifCaf._decode_adaptive``,
  under the tie-free gate: counts and visibility equal, xy within
  1e-3 px, confidences within 2e-3;
- ``golden/torch_wholebody_golden.npz``: its fields equal the scenes bit
  for bit, its poses a fresh JAX decode under the same gate;
- the Cif and Caf targets: bit for bit (NaN where NaN), the same numpy
  operations in the same order;
- the train and eval loaders: bit-equal batches from the same seeded
  global ``np.random`` (augmentation on, no loader workers);
- ``WholeBodyMetric``: identical stats (numpy in both packages);
- one train step of a narrow shell with the wholebody heads and the
  local-centrality training weights: the loss rtol 1e-4, each component
  rtol 1e-3, as ``test_torch_train_trainer.py`` holds the cocokp step;
- the checkpoint's metas: every field equal after the JSON round trip.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpifpaf_tpu import encoder as jax_encoder
from openpifpaf_tpu.annotation import Annotation as JaxAnnotation
from openpifpaf_tpu.decoder.cifcaf import CifCaf as JaxCifCaf
from openpifpaf_tpu.plugins.crowdpose import CrowdPose as JaxCrowdPose
from openpifpaf_tpu.plugins.wholebody import Wholebody as JaxWholebody
from openpifpaf_tpu.plugins.wholebody.metric import \
    WholeBodyMetric as JaxWholeBodyMetric
from openpifpaf_tpu.training import losses as jax_losses
from openpifpaf_tpu.training import optimize as jax_optimize
from openpifpaf_tpu.training.trainer import TrainState, build_train_step
from openpifpaf_tpu_torch import encoder
from openpifpaf_tpu_torch.annotation import Annotation
from openpifpaf_tpu_torch.decoder import CifCaf
from openpifpaf_tpu_torch.models import convert_jax
from openpifpaf_tpu_torch.models.shell import assign_strides
from openpifpaf_tpu_torch.plugins import wholebody
from openpifpaf_tpu_torch.plugins.crowdpose import CrowdPose
from openpifpaf_tpu_torch.plugins.wholebody import Wholebody
from openpifpaf_tpu_torch.plugins.wholebody.metric import WholeBodyMetric
from openpifpaf_tpu_torch.training import checkpoint, losses, optimize
from openpifpaf_tpu_torch.training.trainer import Trainer

import torch_port_helpers as helpers

SEEDS = helpers.WHOLEBODY_SEEDS
EDGE = 97
STRIDE = 16
LOADER_SEED = 7
LOSS_RTOL = 1e-4
HEAD_RTOL = 1e-3
OPT = dict(lr=2e-6, lr_warm_up_epochs=3, lr_warm_up_factor=0.1)
#: the local-centrality weights, as ``--wholebody-apply-local-centrality-
#: weights`` sets them
WEIGHTS = wholebody._C[  # pylint: disable=protected-access
    'TRAINING_WEIGHTS_LOCAL_CENTRALITY']


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    helpers.one_torch_thread()


@pytest.fixture(scope='module')
def jax_scenes():
    """{seed: (cif, caf, JAX's kept poses)} of the contested scenes."""
    decoder = JaxCifCaf(*helpers.jax_wholebody_metas())
    out = {}
    for seed in SEEDS:
        cif, caf = helpers.wholebody_scene(seed)
        out[seed] = (cif, caf, helpers.jax_wholebody_poses(decoder, cif,
                                                           caf))
    return out


@pytest.fixture(scope='module')
def wholebody_set(tmp_path_factory):
    return helpers.write_synthetic_wholebody(
        str(tmp_path_factory.mktemp('wholebody')), n_images=4,
        image_hw=(97, 129), seed=4)


@pytest.fixture(scope='module')
def crowdpose_set(tmp_path_factory):
    return helpers.write_synthetic_crowdpose(
        str(tmp_path_factory.mktemp('crowdpose')), n_images=4,
        image_hw=(97, 129), seed=5)


# -- the decode --------------------------------------------------------------

@pytest.mark.parametrize('seed', SEEDS)
def test_cifcaf_matches_jax_at_133_keypoints(jax_scenes, seed):
    cif, caf, ref = jax_scenes[seed]
    dec = CifCaf(*helpers.port_wholebody_metas())
    anns = dec.batch_decode([torch.from_numpy(cif[None]),
                             torch.from_numpy(caf[None])])[0]
    assert len(ref) >= 2
    assert all(a.data.shape == (133, 3) for a in anns)
    helpers.assert_pose_gate(helpers.pose_rows(anns), list(ref))


@pytest.mark.parametrize('seed', SEEDS)
def test_golden_file_matches_fresh_jax_decode(jax_scenes, seed):
    golden = np.load(helpers.WHOLEBODY_GOLDEN)
    cif, caf, ref = jax_scenes[seed]
    np.testing.assert_array_equal(golden[f'scene{seed}_cif'], cif)
    np.testing.assert_array_equal(golden[f'scene{seed}_caf'], caf)
    helpers.assert_pose_gate(list(golden[f'scene{seed}_poses']), list(ref))


# -- the encoders ------------------------------------------------------------

def test_encoders_match_jax_at_133_keypoints(wholebody_set):
    """One synthetic wholebody image's annotations through both packages'
    Cif (133 fields) and Caf (160 edges) encoders."""
    ann_file, _ = wholebody_set
    with open(ann_file) as f:
        data = json.load(f)
    image_id = max(data['images'], key=lambda i: sum(
        a['image_id'] == i['id'] for a in data['annotations']))['id']
    anns = [{'keypoints': np.asarray(a['keypoints'],
                                     np.float32).reshape(133, 3),
             'bbox': np.asarray(a['bbox'], np.float32), 'iscrowd': False}
            for a in data['annotations'] if a['image_id'] == image_id]
    assert len(anns) >= 2
    image = np.zeros((97, 129, 3), np.float32)
    ours = helpers.port_wholebody_metas(8)
    ref = helpers.jax_wholebody_metas(8)
    for port_enc, jax_enc, meta, r_meta, n in (
            (encoder.Cif, jax_encoder.Cif, ours[0], ref[0], 133),
            (encoder.Caf, jax_encoder.Caf, ours[1], ref[1], 160)):
        t = port_enc(meta)(image, anns, {})
        r = jax_enc(r_meta)(image, anns, {})
        assert t.shape[0] == n and t.shape == r.shape
        assert (t[:, 0] == 1.0).any()
        np.testing.assert_array_equal(t, r)


# -- the pipelines -----------------------------------------------------------

def _train_batches(cls, data, **attrs):
    ann_file, image_dir = data
    with helpers.restored_statics(cls):
        cls.train_annotations = ann_file
        cls.train_image_dir = image_dir
        cls.square_edge = EDGE
        for k, v in attrs.items():
            setattr(cls, k, v)
        datamodule = cls()
        datamodule.batch_size = 2
        # the packages' assign_strides are the same two assignments
        assign_strides(datamodule.head_metas, STRIDE)
        loader = datamodule.train_loader()
        np.random.seed(LOADER_SEED)
        return list(loader)


def _eval_batches(cls, data, batch_size):
    ann_file, image_dir = data
    with helpers.restored_statics(cls):
        cls.eval_annotations = ann_file
        cls.eval_image_dir = image_dir
        cls.eval_long_edge = EDGE
        cls.batch_size = batch_size
        np.random.seed(LOADER_SEED)
        return list(cls().eval_loader())


PIPELINES = {'wholebody': (Wholebody, JaxWholebody, 'wholebody_set', 133),
             'crowdpose': (CrowdPose, JaxCrowdPose, 'crowdpose_set', 14)}


@pytest.mark.parametrize('name', sorted(PIPELINES))
def test_train_batches_equal_jax(name, request):
    """Two batches of 2 at 97 px, augmentation on (crowdpose with its hflip;
    wholebody has none): images, targets (NaN where NaN) and metas."""
    ours_cls, jax_cls, fixture, n_kp = PIPELINES[name]
    data = request.getfixturevalue(fixture)
    ours = _train_batches(ours_cls, data)
    ref = _train_batches(jax_cls, data)
    assert len(ours) == len(ref) == 2
    painted = 0
    for (images, targets, metas), (r_images, r_targets, r_metas) in zip(
            ours, ref):
        assert images.shape == (2, EDGE, EDGE, 3)
        np.testing.assert_array_equal(images, r_images)
        assert targets[0].shape[1:3] == (n_kp, 5)
        painted += int((targets[0][:, :, 0] == 1.0).sum())
        for t, r in zip(targets, r_targets):
            assert t.shape == r.shape and t.dtype == r.dtype
            np.testing.assert_array_equal(t, r)
        for m, r in zip(metas, r_metas):
            assert sorted(m) == sorted(r)
            for key in m:
                if key == 'horizontal_swap':
                    continue
                np.testing.assert_equal(m[key], r[key], err_msg=key)
    assert painted > 0


@pytest.mark.parametrize('batch_size', [1, 2])
@pytest.mark.parametrize('name', sorted(PIPELINES))
def test_eval_batches_equal_jax(name, batch_size, request):
    ours_cls, jax_cls, fixture, n_kp = PIPELINES[name]
    data = request.getfixturevalue(fixture)
    ours = _eval_batches(ours_cls, data, batch_size)
    ref = _eval_batches(jax_cls, data, batch_size)
    assert len(ours) == len(ref) > 0
    n_anns = 0
    for (images, anns, metas), (r_images, r_anns, r_metas) in zip(ours, ref):
        np.testing.assert_array_equal(images, r_images)
        for a, r in zip(metas, r_metas):
            assert a.keys() == r.keys()
            for k in a:
                np.testing.assert_equal(a[k], r[k], err_msg=k)
        for a, r in zip(anns, r_anns):
            assert [type(x).__name__ for x in a] == \
                [type(x).__name__ for x in r]
            for x, y in zip(a, r):
                if hasattr(x, 'data'):
                    assert x.data.shape == (n_kp, 3)
                    np.testing.assert_array_equal(x.data, y.data)
                    np.testing.assert_array_equal(x.bbox(), y.bbox())
                    n_anns += 1
                else:
                    np.testing.assert_array_equal(x.bbox, y.bbox)
    assert n_anns > 0


# -- the metric --------------------------------------------------------------

def _wholebody_stats(annotation_cls, metric_cls, data, seed):
    """``metric_cls`` over the set's ground truth, fed jittered copies of
    it (some dropped, confidences seeded) and one false positive per
    image as ``annotation_cls`` predictions."""
    rng = np.random.RandomState(seed)
    gt_by_image = {i['id']: [a for a in data['annotations']
                             if a['image_id'] == i['id']]
                   for i in data['images']}
    metric = metric_cls(gt_by_image, sigmas=wholebody.WHOLEBODY_SIGMAS)
    for image_id, gts in gt_by_image.items():
        preds = []
        for g in gts:
            if rng.rand() < 0.2:
                continue
            kps = np.asarray(g['keypoints'], np.float32).reshape(133, 3)
            kps[:, :2] += rng.normal(0, rng.uniform(0.5, 4.0), (133, 2))
            kps[:, 2] = np.where(kps[:, 2] > 0, rng.uniform(0.2, 1.0, 133),
                                 0.0)
            preds.append(kps)
        preds.append(np.stack([rng.uniform(0, 129, 133),
                               rng.uniform(0, 97, 133),
                               rng.uniform(0.0, 0.6, 133)], 1))
        anns = [annotation_cls(wholebody.WHOLEBODY_KEYPOINTS,
                               wholebody.WHOLEBODY_SKELETON).set(
                                   p.astype(np.float32),
                                   joint_scales=np.full(133, 2.0))
                for p in preds]
        metric.accumulate(anns, {'image_id': image_id})
    return metric.stats()


@pytest.mark.parametrize('seed', [0, 1])
def test_wholebody_metric_stats_equal_jax(wholebody_set, seed):
    with open(wholebody_set[0]) as f:
        data = json.load(f)
    ours = _wholebody_stats(Annotation, WholeBodyMetric, data, seed)
    ref = _wholebody_stats(JaxAnnotation, JaxWholeBodyMetric, data, seed)
    assert ours['text_labels'] == ref['text_labels']
    assert len(ours['stats']) == 10
    assert 0.0 < ref['stats'][0] < 1.0
    np.testing.assert_array_equal(ours['stats'], ref['stats'])


def test_ground_truth_as_prediction_gives_ap_1(wholebody_set):
    """Each of the five parts' AP and AR is 1.0 with the truth as the
    predictions, through the data module's ``metrics()``."""
    ann_file, _ = wholebody_set
    with open(ann_file) as f:
        data = json.load(f)
    with helpers.restored_statics(Wholebody):
        Wholebody.eval_annotations = ann_file
        metric, = Wholebody().metrics()
    for image in data['images']:
        metric.accumulate([
            Annotation(wholebody.WHOLEBODY_KEYPOINTS,
                       wholebody.WHOLEBODY_SKELETON).set(
                np.asarray(a['keypoints'], np.float32).reshape(133, 3),
                fixed_score=1.0, fixed_bbox=a['bbox'])
            for a in data['annotations'] if a['image_id'] == image['id']],
            {'image_id': image['id']})
    assert metric.stats()['stats'] == [1.0] * 10


# -- one train step ----------------------------------------------------------

def _weighted(cls):
    with helpers.restored_statics(cls):
        cls.training_weights = WEIGHTS
        return cls().head_metas


def test_one_train_step_matches_jax(wholebody_set):
    """A narrow ShuffleNetV2K with the wholebody heads and the
    local-centrality weights (the per-keypoint CIF weights and their
    per-edge CAF weights in the losses), one SGD step on a batch of 2 of
    the wholebody pipeline (augmentation off): the loss and each
    component against JAX's."""
    ann_file, image_dir = wholebody_set
    with helpers.restored_statics(Wholebody):
        datamodule = Wholebody(train_annotations=ann_file,
                               train_image_dir=image_dir, square_edge=EDGE,
                               augmentation=False, batch_size=2)
        assign_strides(datamodule.head_metas, STRIDE)
        np.random.seed(LOADER_SEED)
        images, targets, _ = next(iter(datamodule.train_loader()))
    metas = assign_strides(_weighted(Wholebody), STRIDE)
    jax_metas = assign_strides(_weighted(JaxWholebody), STRIDE)
    assert metas[1].training_weights == jax_metas[1].training_weights

    jax_model = helpers.jax_narrow_shell(jax_metas)
    variables = jax.tree_util.tree_map(np.asarray, helpers.randomize_variables(
        jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, 65, 65, 3)),
                       train=True), seed=11))
    loss_fn = jax_losses.Factory().factory(jax_metas)
    optimizer, schedule = jax_optimize.factory_optimizer(
        helpers.optimizer_args(**OPT), training_batches_per_epoch=1)
    params = variables['params']
    loss_params = loss_fn.init_params()
    state = TrainState(
        params=params, batch_stats=variables['batch_stats'],
        opt_state=optimizer.init({'model': params, 'loss': loss_params}),
        ema_params=jax.tree_util.tree_map(jnp.copy, params),
        step=jnp.zeros((), dtype=jnp.int32), loss_params=loss_params,
        loss_state=loss_fn.init_state(), grad_accum={})
    step = build_train_step(jax_model, loss_fn, optimizer, schedule)
    with helpers.jax_f32():
        _, ref_loss, ref_heads = step(state, jnp.asarray(images),
                                      tuple(jnp.asarray(t) for t in targets))

    model = helpers.port_narrow_shell(metas)
    convert_jax.load_jax_variables(model, variables)
    optimizer, schedule = optimize.factory_optimizer(
        helpers.optimizer_args(**OPT), training_batches_per_epoch=1)
    trainer = Trainer(model, losses.Factory().factory(metas), optimizer,
                      schedule, 'unused', device='cpu')
    loss, heads = trainer.train_step(
        torch.from_numpy(images), tuple(torch.from_numpy(t)
                                        for t in targets))
    assert np.isfinite(float(loss))
    assert len(heads) == 6
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=LOSS_RTOL)
    np.testing.assert_allclose([float(h) for h in heads],
                               [float(h) for h in ref_heads],
                               rtol=HEAD_RTOL)


# -- the checkpoint ----------------------------------------------------------

def test_checkpoint_round_trips_wholebody_metas(tmp_path):
    """A checkpoint's JSON keeps every field of the wholebody Cif and Caf
    metas: 133 keypoints, the score and training weights, the 160-edge
    skeleton and the upright pose."""
    metas = assign_strides(_weighted(Wholebody), STRIDE)
    path = str(tmp_path / 'wholebody')
    checkpoint.save(path, state_dict={}, meta={
        'head_metas': [checkpoint.headmeta_to_dict(m) for m in metas]})
    _, meta = checkpoint.load(path)
    loaded = [checkpoint.headmeta_from_dict(d) for d in meta['head_metas']]
    assert [type(m) for m in loaded] == [type(m) for m in metas]
    for m, r in zip(metas, loaded):
        for f in dataclasses.fields(m):
            a, b = getattr(m, f.name), getattr(r, f.name)
            if isinstance(a, (list, tuple, np.ndarray)):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                              err_msg=f.name)
            else:
                assert a == b, f.name
        assert (r.head_index, r.base_stride, r.upsample_stride) == \
            (m.head_index, m.base_stride, m.upsample_stride)
    assert len(loaded[0].keypoints) == 133
    assert len(loaded[1].skeleton) == 160
    assert loaded[0].training_weights == WEIGHTS
    assert loaded[0].score_weights == wholebody.WHOLEBODY_SCORE_WEIGHTS
