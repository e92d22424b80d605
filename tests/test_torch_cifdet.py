"""CifDet detection of the PyTorch port against the JAX package: the
encoder, the decode and the decoder class, the CifDet heads (on a narrow
ShuffleNetV2K and on ``Cifar10Net``), one train step with the CifDet
loss, the checkpoint's metas and the Predictor.

Tolerances:
- the encoder: bit for bit (NaN where NaN), the same numpy operations in
  the same order;
- the decode, on every one of the n_seeds slots: the same keep mask and
  categories, scores within 2e-6, boxes within 1e-3 px
  (``torch_port_helpers.assert_det_gate``); the seeded scenes include one
  with exact score ties and cover each config field;
- ``golden/torch_cifdet_golden.npz``: its fields equal the scenes bit for
  bit, its detections a fresh JAX decode under the same gate;
- the decoder class: the same annotations in the same order, categories
  equal, scores within 2e-6, boxes within 1e-3 px;
- the fields of a model with the CifDet head: within 1e-5 of each head's
  largest value (float32 convolutions in two frameworks);
- one train step: the loss rtol 1e-4, each component rtol 1e-3, as
  ``test_torch_train_trainer.py`` holds the cocokp step;
- the Predictor's JSON: categories equal, scores within one rounding step
  of ``json_data`` (1e-3), boxes within one (0.01 px).
"""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openpifpaf_tpu
from openpifpaf_tpu import decoder as jax_decoder
from openpifpaf_tpu import encoder as jax_encoder
from openpifpaf_tpu import headmeta as jax_headmeta
from openpifpaf_tpu.models.heads import CompositeField4 as JaxCompositeField4
from openpifpaf_tpu.models.shell import Shell as JaxShell
from openpifpaf_tpu.plugins.cifar10 import Cifar10Net as JaxCifar10Net
from openpifpaf_tpu.plugins.coco.cocodet import CocoDet as JaxCocoDet
from openpifpaf_tpu.training import losses as jax_losses
from openpifpaf_tpu.training import optimize as jax_optimize
from openpifpaf_tpu.training.trainer import TrainState, build_train_step
from openpifpaf_tpu_torch import decoder, encoder, headmeta
from openpifpaf_tpu_torch.models import convert_jax
from openpifpaf_tpu_torch.models.factory import Factory
from openpifpaf_tpu_torch.models.shell import assign_strides
from openpifpaf_tpu_torch.ops import decode_cifdet
from openpifpaf_tpu_torch.plugins.coco.cocodet import CocoDet
from openpifpaf_tpu_torch.predictor import Predictor
from openpifpaf_tpu_torch.training import checkpoint, losses, optimize
from openpifpaf_tpu_torch.training.trainer import Trainer

import torch_port_helpers as helpers

EDGE = 97
STRIDE = 16
LOADER_SEED = 7
LOSS_RTOL = 1e-4
HEAD_RTOL = 1e-3
FIELD_RTOL = 1e-5
OPT = dict(lr=2e-6, lr_warm_up_epochs=3, lr_warm_up_factor=0.1)
#: a stride-8 scene: 161x209 pixels, 5 categories
STRIDE8 = dict(hw=(161, 209), stride=8, n_categories=5)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    helpers.one_torch_thread()


def _stride8_scene():
    objects = [(0, 60.0, 70.0, 50.0, 80.0), (1, 150.0, 80.0, 40.0, 30.0),
               (0, 160.0, 120.0, 60.0, 40.0), (0, 150.0, 110.0, 64.0, 44.0),
               (3, 40.0, 140.0, 30.0, 30.0)]
    return helpers.cifdet_scene(objects, seed=5, noise=0.4, clutter=0.08,
                                **STRIDE8)


SCENES = {'sparse': helpers.cifdet_sparse_scene,
          'contested': helpers.cifdet_contested_scene,
          'tie': helpers.cifdet_tie_scene,
          'stride8': _stride8_scene}

#: (scene, config overrides): each config field, the exact ties under the
#: budgets and the NMS across categories, and a stride-8 scene
DECODE_CASES = [
    ('contested', {'iou_threshold': 0.3}),
    ('contested', {'suppression': 0.0}),
    ('contested', {'instance_threshold': 0.05}),
    ('contested', {'n_detections': 3}),
    ('sparse', {'nms_by_category': False, 'seed_threshold': 0.3}),
    ('tie', {}),
    ('tie', {'nms_by_category': False}),
    ('tie', {'n_detections': 2}),
    ('tie', {'n_seeds': 40, 'n_hr_cells': 8}),
    ('stride8', {}),
]


@pytest.fixture(scope='module')
def scenes():
    return {name: make() for name, make in SCENES.items()}


def _stride(scene):
    return STRIDE8['stride'] if scene == 'stride8' else STRIDE


def _port_decode(fields, stride, overrides):
    return {k: v.numpy() for k, v in decode_cifdet.decode_cifdet_single(
        torch.from_numpy(fields), stride=stride,
        config=decode_cifdet.CifDetDecoderConfig(**overrides)).items()}


# -- the decode --------------------------------------------------------------

@pytest.mark.parametrize('scene, overrides', DECODE_CASES,
                         ids=[f'{s}-{"-".join(o) or "default"}'
                              for s, o in DECODE_CASES])
def test_decode_matches_jax(scenes, scene, overrides):
    fields = scenes[scene]
    ref = helpers.jax_cifdet_decode(fields, _stride(scene), overrides)
    ours = _port_decode(fields, _stride(scene), overrides)
    assert ref['keep'].sum() >= 2
    helpers.assert_det_gate(ours, ref, f'{scene} {overrides}')


def test_tie_scene_has_exact_ties_that_decide(scenes):
    """Every accepted seed of the tie scene scores exactly the same, and the
    tie order decides what the budgets and the NMS across categories
    keep."""
    fields = scenes['tie']
    out = _port_decode(fields, STRIDE, {})
    scored = out['score'][out['score'] > 0]
    assert len(scored) == 6 and np.all(scored == scored[0])
    across = _port_decode(fields, STRIDE, {'nms_by_category': False})
    assert across['keep'].sum() == 4
    assert _port_decode(fields, STRIDE, {'n_detections': 2})['keep'].sum() \
        == 2


@pytest.mark.parametrize('scene', helpers.CIFDET_SCENES)
@pytest.mark.parametrize('config', sorted(helpers.CIFDET_CONFIGS))
def test_golden_detections_match_port(scene, config):
    golden = np.load(helpers.CIFDET_GOLDEN)
    fields = helpers.cifdet_golden_fields(golden)[scene]
    assert fields.shape == (80, 6, 33, 41)
    ref = {k: golden[f'{scene}_{config}_{k}']
           for k in ('category', 'score', 'box', 'keep')}
    assert ref['keep'].sum() >= 4
    helpers.assert_det_gate(
        _port_decode(fields, STRIDE, helpers.CIFDET_CONFIGS[config]), ref,
        f'{scene} {config}')


@pytest.mark.parametrize('scene', helpers.CIFDET_SCENES)
def test_golden_file_matches_fresh_jax_decode(scenes, scene):
    golden = np.load(helpers.CIFDET_GOLDEN)
    np.testing.assert_array_equal(helpers.cifdet_golden_fields(golden)[scene],
                                  scenes[scene])
    for config, overrides in helpers.CIFDET_CONFIGS.items():
        ref = helpers.jax_cifdet_decode(scenes[scene], overrides=overrides)
        stored = {k: golden[f'{scene}_{config}_{k}']
                  for k in ('category', 'score', 'box', 'keep')}
        helpers.assert_det_gate(stored, ref, f'{scene} {config}')


def _scan(candidate, blocks, cap=None):
    keep = np.zeros_like(candidate)
    for i in range(len(candidate)):
        keep[i] = (candidate[i] and not np.any(keep & blocks[i])
                   and (cap is None or keep[:i].sum() < cap))
    return keep


@pytest.mark.parametrize('cap', [None, 3])
def test_greedy_keep_equals_the_sequential_scan(cap):
    """The bounded fixpoint against the scan it replaces, on random lower
    triangular blocking relations with long chains (dense: each seed
    blocked by half of the earlier ones)."""
    rng = np.random.RandomState(3)
    n = 40
    candidate = rng.rand(4, n) < 0.8
    blocks = (rng.rand(4, n, n) < 0.5) & np.tri(n, k=-1, dtype=bool)
    ours = decode_cifdet.greedy_keep(torch.from_numpy(candidate),
                                     torch.from_numpy(blocks), cap=cap)
    ref = np.stack([_scan(c, b, cap) for c, b in zip(candidate, blocks)])
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_batched_decode_equals_single_images(scenes):
    batch = np.stack([scenes['sparse'], scenes['contested']])
    config = decode_cifdet.CifDetDecoderConfig()
    out = decode_cifdet.build_cifdet_decoder(stride=STRIDE, config=config)(
        torch.from_numpy(batch))
    for i, scene in enumerate(('sparse', 'contested')):
        single = _port_decode(scenes[scene], STRIDE, {})
        for key, value in single.items():
            np.testing.assert_array_equal(out[key][i].numpy(), value)


# -- the decoder class and its factory ---------------------------------------

def _metas(module, n_categories=80, stride=STRIDE):
    meta = module.CifDet('cifdet', 'cocodet', categories=[
        f'c{i}' for i in range(n_categories)])
    meta.head_index = 0
    meta.base_stride = stride
    return [meta]


def test_decoder_gives_jax_annotations(scenes):
    batch = np.stack([scenes['sparse'], scenes['contested']])
    with helpers.jax_f32():
        ref = jax_decoder.CifDet(_metas(jax_headmeta)).batch_decode([batch])
    dec = decoder.CifDet(_metas(headmeta))
    ours = dec.batch_decode([torch.from_numpy(batch)])
    assert dec.last_decoder_time > 0.0
    assert [len(a) for a in ours] == [len(a) for a in ref]
    assert all(len(a) >= 4 for a in ref)
    for image_ours, image_ref in zip(ours, ref):
        for a, b in zip(image_ours, image_ref):
            assert a.category_id == b.category_id
            assert a.category == b.category
            assert abs(a.score - b.score) <= 2e-6
            np.testing.assert_allclose(a.bbox, b.bbox, atol=1e-3, rtol=0)
            assert a.json_data().keys() == b.json_data().keys()


def test_factory_picks_and_configures_cifdet():
    """``--decoder cifdet:0`` picks the CifDet decoder of a cocodet head;
    ``--cifdet-iou-threshold``, ``--cif-th`` and the predict CLI's shared
    ``--seed-threshold``/``--instance-threshold`` configure it as in JAX."""
    argv = ['--decoder', 'cifdet:0', '--cifdet-iou-threshold', '0.4',
            '--cif-th', '0.25', '--seed-threshold', '0.1',
            '--instance-threshold', '0.2']
    configs = []
    for module, package in ((decoder, headmeta),
                            (jax_decoder.factory, jax_headmeta)):
        parser = argparse.ArgumentParser()
        with helpers.restored_statics(*module.DECODERS):
            module.cli(parser)
            args = parser.parse_args(argv)
            module.configure(args)
            built = module.decoders(_metas(package), args.decoder)
        assert [type(d).__name__ for d in built] == ['CifDet']
        configs.append(dataclasses.asdict(built[0].config))
    assert configs[0] == configs[1]
    assert configs[0]['iou_threshold'] == 0.4
    assert configs[0]['cifhr_threshold'] == 0.25
    assert configs[0]['seed_threshold'] == 0.1
    assert configs[0]['instance_threshold'] == 0.2
    # the default registry builds it too, beside no pose decoder
    multi = decoder.factory(_metas(headmeta))
    assert [type(d).__name__ for d in multi.decoders] == ['CifDet']


# -- the encoder -------------------------------------------------------------

def test_encoder_matches_golden_cifdet_0():
    """The input of ``tools/capture_encoder_golden.py``'s ``cifdet_0``
    through the port's encoder gives the stored targets bit for bit."""
    meta = headmeta.CifDet('cifdet', 'test', categories=['a', 'b', 'c'])
    meta.base_stride = 16
    anns = [
        {'category_id': 1, 'bbox': np.array([30., 40., 80., 60.]),
         'iscrowd': False},
        {'category_id': 2, 'bbox': np.array([100., 90., 120., 100.]),
         'iscrowd': False},
        {'category_id': 1, 'bbox': np.array([90., 50., 70., 90.]),
         'iscrowd': False},
        {'category_id': 3, 'bbox': np.array([200., 10., 60., 40.]),
         'iscrowd': True},
    ]
    out = encoder.CifDet(meta)(np.zeros((241, 321, 3), np.float32), anns,
                               {'valid_area': np.array([4., 4., 310., 230.])})
    golden = np.load(helpers.os.path.join(
        helpers.os.path.dirname(helpers.GOLDEN), 'encoder_golden.npz'))
    np.testing.assert_array_equal(out, golden['cifdet_0'])
    assert (out[:, 0] == 1.0).any() and np.isnan(out[:, 0]).any()


@pytest.mark.parametrize('seed', [0, 1])
def test_encoder_matches_jax_with_crowds_and_valid_area(seed):
    """Random boxes of 4 categories on a 193x257 image at stride 8, some
    crowd, some cut by the valid area or reaching past the image, through
    both packages' CifDet encoders."""
    rng = np.random.RandomState(seed)
    anns = []
    for _ in range(9):
        w, h = rng.uniform(8, 120), rng.uniform(8, 120)
        anns.append({'category_id': int(rng.randint(1, 5)),
                     'bbox': np.array([rng.uniform(-30, 240),
                                       rng.uniform(-30, 180), w, h]),
                     'iscrowd': bool(rng.rand() < 0.25)})
    image = np.zeros((193, 257, 3), np.float32)
    area = {'valid_area': np.array([20.0, 12.0, 200.0, 150.0])}
    outs = []
    for package, enc in ((headmeta, encoder), (jax_headmeta, jax_encoder)):
        meta = package.CifDet('cifdet', 'test', categories=list('abcd'))
        meta.base_stride = 8
        outs.append(enc.CifDet(meta)(image, anns, dict(area)))
    assert outs[0].shape == (4, 7, 25, 33)
    assert (outs[0][:, 0] == 1.0).sum() >= 3
    np.testing.assert_array_equal(outs[0], outs[1])


# -- models, a train step, the checkpoint ------------------------------------

def _cocodet_metas(cls):
    return assign_strides(cls().head_metas, STRIDE)


def _bridged(jax_model, torch_model, shape, seed):
    variables = jax.tree_util.tree_map(np.asarray, helpers.randomize_variables(
        jax_model.init(jax.random.PRNGKey(seed), jnp.zeros(shape),
                       train=True), seed=seed))
    convert_jax.load_jax_variables(torch_model, variables)
    return variables


@pytest.mark.parametrize('backbone', ['cifar10net', 'narrow k16'])
def test_cifdet_head_fields_match_jax(backbone):
    """The decoded CifDet fields [logb, c, x, y, w, h] of a Cifar10Net
    with the cifar10 head and of a narrow ShuffleNetV2K with the cocodet
    head, bridged from random flax variables."""
    if backbone == 'cifar10net':
        jax_metas = _metas(jax_headmeta, 10)
        metas = _metas(headmeta, 10)
        jax_model = JaxShell(base_net=JaxCifar10Net(), head_nets=(
            JaxCompositeField4(meta=jax_metas[0]),))
        model = Factory('cifar10net').from_scratch(metas)
        shape = (2, 32, 32, 3)
    else:
        jax_metas = _cocodet_metas(JaxCocoDet)
        metas = _cocodet_metas(CocoDet)
        jax_model = helpers.jax_narrow_shell(jax_metas)
        model = helpers.port_narrow_shell(metas)
        shape = (1, 65, 81, 3)
    variables = _bridged(jax_model, model, shape, seed=4)
    x = np.random.RandomState(5).randn(*shape).astype(np.float32)
    with helpers.jax_f32():
        ref = np.asarray(jax_model.apply(variables, jnp.asarray(x))[0])
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(x))[0].numpy()
    assert out.shape == ref.shape == (
        (shape[0], len(metas[0].categories), 6)
        + tuple((s - 1) // STRIDE + 1 for s in shape[1:3]))
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=FIELD_RTOL * np.abs(ref).max())


@pytest.fixture(scope='module')
def cocodet_set(tmp_path_factory):
    return helpers.write_synthetic_cocodet(
        str(tmp_path_factory.mktemp('cocodet')), n_images=4,
        image_hw=(97, 129), seed=6, keypoints=True)


def test_one_train_step_matches_jax(cocodet_set):
    """A narrow ShuffleNetV2K with the cocodet head, one SGD step on a
    batch of 2 of the cocodet pipeline (augmentation off) with the CifDet
    loss: the loss and its two components against JAX's."""
    ann_file, image_dir = cocodet_set
    with helpers.restored_statics(CocoDet):
        CocoDet.train_annotations = ann_file
        CocoDet.train_image_dir = image_dir
        CocoDet.square_edge = EDGE
        CocoDet.augmentation = False
        datamodule = CocoDet()
        datamodule.batch_size = 2
        assign_strides(datamodule.head_metas, STRIDE)
        np.random.seed(LOADER_SEED)
        images, targets, _ = next(iter(datamodule.train_loader()))
    assert targets[0].shape == (2, 80, 7, 7, 7)
    assert (targets[0][:, :, 0] == 1.0).any()
    metas = _cocodet_metas(CocoDet)
    jax_metas = _cocodet_metas(JaxCocoDet)

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
    loss_fn = losses.Factory().factory(metas)
    assert loss_fn.field_names == ['cocodet.cifdet.c', 'cocodet.cifdet.vec']
    trainer = Trainer(model, loss_fn, optimizer, schedule, 'unused',
                      device='cpu')
    loss, heads = trainer.train_step(
        torch.from_numpy(images), tuple(torch.from_numpy(t)
                                        for t in targets))
    assert np.isfinite(float(loss)) and len(heads) == 2
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=LOSS_RTOL)
    np.testing.assert_allclose([float(h) for h in heads],
                               [float(h) for h in ref_heads],
                               rtol=HEAD_RTOL)


def test_checkpoint_round_trips_cocodet_metas(tmp_path):
    """A cocodet checkpoint keeps every field of the CifDet meta through
    its JSON, and ``load_shell`` rebuilds the model (a ``cifar10net``
    backbone, which the cifar10 plugin registers) with its weights."""
    metas = _cocodet_metas(CocoDet)
    model = Factory('cifar10net').from_scratch(metas)
    path = str(tmp_path / 'cocodet')
    checkpoint.save(path, state_dict=model.state_dict(), meta={
        'base_name': 'cifar10net',
        'head_metas': [checkpoint.headmeta_to_dict(m) for m in metas]})
    loaded, meta = checkpoint.load_shell(path)
    (ours,) = loaded.head_metas
    assert type(ours) is headmeta.CifDet
    for f in dataclasses.fields(metas[0]):
        assert getattr(ours, f.name) == getattr(metas[0], f.name), f.name
    assert (ours.head_index, ours.base_stride, ours.upsample_stride,
            ours.stride) == (0, 16, 1, 16)
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 32, 48, 3)
                         .astype(np.float32))
    with torch.no_grad():
        np.testing.assert_array_equal(loaded.eval()(x)[0].numpy(),
                                      model.eval()(x)[0].numpy())


# -- the Predictor -----------------------------------------------------------

def test_predictor_gives_jax_detections():
    """``Predictor(device='cpu')`` of a narrow ShuffleNetV2K with the cocodet
    head against the JAX Predictor on the same flax variables, one 97x129
    image; the confidence biases are raised by 2 and the box sizes' by 3,
    and the seed and instance thresholds lowered (0.05, 0.01), so that
    random weights detect."""
    jax_metas = openpifpaf_tpu.datasets.factory('cocodet').head_metas
    jax_model = helpers.jax_narrow_shell(jax_metas)
    variables = jax.tree_util.tree_map(np.asarray, jax_model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 65, 65, 3)), train=True))
    bias = variables['params']['head_nets_0']['Conv_0']['bias']
    bias = bias.reshape(80, 6).copy()
    bias[:, 1] += 2.0
    bias[:, 4:6] += 3.0
    variables['params']['head_nets_0']['Conv_0']['bias'] = bias.reshape(-1)
    model = helpers.port_narrow_shell(
        assign_strides(CocoDet().head_metas, STRIDE))
    convert_jax.load_jax_variables(model, variables)

    with helpers.restored_statics(jax_decoder.CifDet, decoder.CifDet):
        for cls in (jax_decoder.CifDet, decoder.CifDet):
            cls.seed_threshold = 0.05
            cls.instance_threshold = 0.01
        jax_predictor = openpifpaf_tpu.Predictor(model=jax_model,
                                                 variables=variables)
        port = Predictor(model=model, device='cpu')
    jax_predictor.pipeline_decode = False
    jax_predictor.backbone_engine = 'flax'
    image = np.random.RandomState(1).randint(0, 256, (97, 129, 3),
                                             dtype=np.uint8)
    with helpers.jax_f32():
        (ref, _, _), = list(jax_predictor.numpy_images([image]))
    (ours, _, _), = list(port.numpy_images([image]))
    ref = [a.json_data() for a in ref]
    ours = [a.json_data() for a in ours]
    assert len(ours) == len(ref) >= 5
    for a, b in zip(ours, ref):
        assert a['category_id'] == b['category_id']
        assert a['category'] == b['category']
        # json_data rounds boxes to 2 digits and scores to 3
        assert abs(a['score'] - b['score']) <= 0.00101
        np.testing.assert_allclose(a['bbox'], b['bbox'], atol=0.0101, rtol=0)
