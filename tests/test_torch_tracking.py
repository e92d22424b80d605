"""Tracking pieces of the PyTorch port against the JAX package: the CifHr
field-index clamp of the CAF rescoring, the tracking head metas, the
tracking shell (through the weight bridge), its checkpoint and the decoder
factory.

The clamp: ``TrackingPose``'s cross-frame edges name joints 18-34 of a
17-field CifHr; JAX's gather clamps such an index to the last field, so
the port must too (before the repair it raised ``IndexError``). The shell:
a narrow ShuffleNetV2K ``TrackingShell`` with random flax weights gives
JAX's (cif, caf, tcaf) on an interleaved pair batch within 1e-4 of each
head's largest value (float32 convolutions in two frameworks).
"""

import argparse
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openpifpaf_tpu
from openpifpaf_tpu import decoder as jax_decoder
from openpifpaf_tpu.models import factory as jax_factory
from openpifpaf_tpu.ops import caf_scored as jax_caf_scored
from openpifpaf_tpu.ops import cifhr as jax_cifhr
from openpifpaf_tpu.plugins.coco.cocokp import CocoKp as JaxCocoKp
from openpifpaf_tpu_torch import decoder as port_decoder
from openpifpaf_tpu_torch import datasets
from openpifpaf_tpu_torch.models import basenetworks, convert_jax
from openpifpaf_tpu_torch.models import factory as port_factory
from openpifpaf_tpu_torch.models.tracking import TrackingShell
from openpifpaf_tpu_torch.ops import caf_scored as port_caf_scored
from openpifpaf_tpu_torch.ops import cifhr as port_cifhr
from openpifpaf_tpu_torch.plugins.coco.cocokp import CocoKp
from openpifpaf_tpu_torch.predictor import Predictor
from openpifpaf_tpu_torch.training import checkpoint

from torch_port_helpers import NARROW, jax_f32, \
    jax_narrow_tracking_shell, jax_tracking_decoder, jax_tracking_metas, \
    one_torch_thread, port_tracking_decoder, port_tracking_metas, \
    randomize_variables, restored_statics

STRIDE = 16


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    one_torch_thread()


# -- the clamp of the CifHr field index ------------------------------------

#: 2 CIF fields; edges to joints 2, 4 and 5 (0-based 1, 3, 4): the last
#: two at or beyond F
SKELETON = [(1, 2), (1, 4), (5, 2)]


def _caf_and_hr(seed=0, h=9, w=11, stride=8):
    rng = np.random.RandomState(seed)
    caf = np.zeros((len(SKELETON), 8, h, w), np.float32)
    caf[:, 1] = rng.uniform(0.0, 1.0, (len(SKELETON), h, w))
    caf[:, 2:6] = rng.uniform(-1.0, max(h, w), (len(SKELETON), 4, h, w))
    caf[:, 6:8] = rng.uniform(0.5, 3.0, (len(SKELETON), 2, h, w))
    hs, ws = (h - 1) * stride + 1, (w - 1) * stride + 1
    hr = rng.uniform(0.0, 1.0, (2, hs, ws)).astype(np.float32)
    cells = {k: rng.uniform(lo, hi, (2, 16)).astype(np.float32)
             for k, lo, hi in (('x', -4.0, ws + 4.0), ('y', -4.0, hs + 4.0),
                               ('sigma', 1.0, 12.0), ('w', 0.0, 0.5))}
    return caf, hr, cells, (hs, ws), stride


@pytest.mark.parametrize('cifhr', ['map', 'lazy'])
@pytest.mark.parametrize('n_candidates', [0, 16])
def test_caf_scored_clamps_joints_beyond_cif_fields(cifhr, n_candidates):
    """Skeleton joints at or beyond the CifHr's field count read its last
    field, as JAX's gather does; the rescored candidates equal JAX's."""
    caf, hr, cells, hr_shape, stride = _caf_and_hr()
    kw = dict(score_th=0.1, n_candidates=n_candidates)
    if cifhr == 'map':
        ref = jax_caf_scored.caf_scored(jnp.asarray(caf), jnp.asarray(hr),
                                        stride, SKELETON, **kw)
        out = port_caf_scored.caf_scored(torch.from_numpy(caf),
                                         torch.from_numpy(hr), stride,
                                         SKELETON, **kw)
    else:
        ref = jax_caf_scored.caf_scored(
            jnp.asarray(caf), None, stride, SKELETON, hr_shape=hr_shape,
            hr_cells={k: jnp.asarray(v) for k, v in cells.items()}, **kw)
        out = port_caf_scored.caf_scored(
            torch.from_numpy(caf), None, stride, SKELETON, hr_shape=hr_shape,
            hr_cells={k: torch.from_numpy(v) for k, v in cells.items()},
            **kw)
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    # the clamped edges were rescored, not dropped
    assert float(out['c'][1].sum()) > 0.0 and float(out['c'][2].sum()) > 0.0


def test_cifhr_lookup_clamps_field_index():
    _, hr, _, (hs, ws), _ = _caf_and_hr(seed=1)
    f = np.array([0, 1, 2, 7, 33])
    x = np.array([3.2, 17.6, 40.0, 5.0, -3.0], np.float32)
    y = np.array([1.0, 30.4, 12.2, 60.0, 2.0], np.float32)
    ref = jax_cifhr.cifhr_lookup(jnp.asarray(hr), jnp.asarray(f),
                                 jnp.asarray(x), jnp.asarray(y))
    out = port_cifhr.cifhr_lookup(torch.from_numpy(hr), torch.from_numpy(f),
                                  torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# -- head metas --------------------------------------------------------------

@pytest.mark.parametrize('with_dense', [False, True])
def test_cocokpst_metas_match_jax(with_dense):
    with restored_statics(CocoKp, JaxCocoKp):
        CocoKp.with_dense = JaxCocoKp.with_dense = with_dense
        ours = datasets.factory('cocokpst').head_metas
        ref = openpifpaf_tpu.datasets.factory('cocokpst').head_metas
    assert [type(m).__name__ for m in ours] == \
        [type(m).__name__ for m in ref] == (
            ['TSingleImageCif', 'TSingleImageCaf', 'TSingleImageCaf', 'Tcaf']
            if with_dense else ['TSingleImageCif', 'TSingleImageCaf', 'Tcaf'])
    for o, r in zip(ours, ref):
        d_o, d_r = dataclasses.asdict(o), dataclasses.asdict(r)
        for k in d_r:
            if isinstance(d_r[k], np.ndarray):
                np.testing.assert_array_equal(d_o[k], d_r[k])
            else:
                assert d_o[k] == d_r[k], k
        assert (o.n_fields, o.n_components) == (r.n_fields, r.n_components)
        if type(o).__name__ == 'Tcaf':
            assert o.skeleton == r.skeleton
            assert len(o.keypoints) == 34


def test_cocokpst_training_is_not_ported(tmp_path):
    """Tracking training is ported now: cocokpst's train and val loaders
    no longer raise; they load pairs (half the batch size) through the
    tracking collate (``tests/test_torch_tracking_train.py`` holds their
    batches against JAX's)."""
    from openpifpaf_tpu_torch.datasets import collate
    from torch_port_helpers import write_synthetic_coco
    ann_file, image_dir = write_synthetic_coco(str(tmp_path), n_images=2)
    with restored_statics(CocoKp):
        CocoKp.train_annotations = CocoKp.val_annotations = ann_file
        CocoKp.train_image_dir = CocoKp.val_image_dir = image_dir
        datamodule = datasets.factory('cocokpst')
        datamodule.batch_size = 8
        for make_loader in (datamodule.train_loader, datamodule.val_loader):
            loader = make_loader()
            assert loader.batch_size == 4
            assert loader.collate_fn is \
                collate.collate_tracking_images_targets_meta


def test_checkpoint_metas_round_trip():
    metas = port_tracking_metas(STRIDE)
    back = [checkpoint.headmeta_from_dict(checkpoint.headmeta_to_dict(m))
            for m in metas]
    assert [type(m) for m in back] == [type(m) for m in metas]
    assert back[2].skeleton == metas[2].skeleton
    np.testing.assert_array_equal(back[2].pose, metas[2].pose)


# -- the tracking shell ------------------------------------------------------

def _jax_narrow_tracking_shell():
    return jax_narrow_tracking_shell(jax_tracking_metas(STRIDE))


@pytest.fixture(scope='module')
def shells():
    """(JAX model, its random variables, the bridged port model)."""
    model = _jax_narrow_tracking_shell()
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((2, 97, 129, 3)), train=True)
    variables = randomize_variables(jax.tree_util.tree_map(
        np.asarray, variables), seed=3)
    port = port_factory.Factory().from_scratch(
        port_tracking_metas(STRIDE),
        base_net=basenetworks.ShuffleNetV2K(*NARROW))
    convert_jax.load_jax_variables(port, variables)
    return model, variables, port.eval()


def _frames(n, seed, hw=(97, 129)):
    return np.random.RandomState(seed).randn(n, *hw, 3).astype(np.float32)


def test_tracking_shell_matches_jax(shells):
    """An interleaved batch of two pairs: cif and caf of the primary
    frames, tcaf of each pair."""
    model, variables, port = shells
    assert isinstance(port, TrackingShell)
    images = _frames(4, seed=5)
    with jax_f32():
        ref = jax.jit(functools.partial(model.apply, train=False))(
            variables, jnp.asarray(images))
    with torch.no_grad():
        out = port(torch.from_numpy(images))
    assert [tuple(o.shape) for o in out] == [r.shape for r in ref] == [
        (2, 17, 5, 7, 9), (2, 19, 8, 7, 9), (2, 17, 8, 7, 9)]
    for o, r, name in zip(out, ref, ('cif', 'caf', 'tcaf')):
        r = np.asarray(r)
        assert float(r[:, :, 1].std()) > 1e-3, name  # not constant
        np.testing.assert_allclose(o.numpy(), r, rtol=0,
                                   atol=1e-4 * np.abs(r).max(), err_msg=name)


def test_tracking_heads_on_pairs_match_jax(shells):
    """``backbone`` per frame, then ``heads`` on [frame, previous frame]
    (the Predictor's split), and train-mode raw outputs."""
    model, variables, port = shells
    images = _frames(2, seed=6)
    with jax_f32():
        feats = model.apply(variables, jnp.asarray(images), train=False,
                            method=model.backbone)
        pair = jnp.concatenate([feats[1:], feats[:1]])
        ref = model.apply(variables, pair, train=False, method=model.heads)
        ref_train = model.apply(variables, pair, train=True,
                                method=model.heads)
    with torch.no_grad():
        x = port.backbone(torch.from_numpy(images))
        pair = torch.cat([x[1:], x[:1]])
        out = port.heads(pair)
        out_train = port.heads(pair, train=True)
    np.testing.assert_allclose(x.permute(0, 2, 3, 1).numpy(),
                               np.asarray(feats), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(feats)).max())
    for o, r in zip(out + out_train, ref + ref_train):
        r = np.asarray(r)
        np.testing.assert_allclose(o.numpy(), r, rtol=0,
                                   atol=1e-4 * np.abs(r).max())


def test_tcaf_on_odd_batch_is_none(shells):
    model, variables, port = shells
    images = _frames(3, seed=7)
    ref = model.apply(variables, jnp.asarray(images), train=False)
    with torch.no_grad():
        out = port(torch.from_numpy(images))
    assert ref[2] is None and out[2] is None
    assert tuple(out[0].shape) == ref[0].shape == (2, 17, 5, 7, 9)


def test_full_width_tracking_bridge_is_strict():
    """The flax names of a full-width tshufflenetv2k16 tracking shell
    (``jax.eval_shape`` of its init, no weights) load strictly into the
    port's; one extra or one missing variable raises."""
    metas = jax_tracking_metas(STRIDE)
    model, init = jax_factory.Factory(
        base_name='tshufflenetv2k16').from_scratch(metas)
    shapes = jax.eval_shape(lambda: init(jax.random.PRNGKey(0),
                                         (2, 97, 129, 3)))
    variables = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes)
    port = port_factory.Factory('tshufflenetv2k16').from_scratch(
        port_tracking_metas(STRIDE))
    assert isinstance(port, TrackingShell)
    convert_jax.load_jax_variables(port, variables)
    assert [type(h).__name__ for h in port.head_nets] == [
        'TBaseSingleImage', 'TBaseSingleImage', 'Tcaf']
    assert port.head_nets[2].feature_reduction.in_channels == 1392
    extra = jax.tree_util.tree_map(lambda a: a, variables)
    extra['params']['head_nets_2']['unexpected'] = {'kernel': np.zeros(1)}
    with pytest.raises(KeyError, match='no port counterpart'):
        convert_jax.state_dict_from_jax(extra)
    del variables['params']['head_nets_2']['feature_compute']
    with pytest.raises(KeyError, match='missing'):
        convert_jax.state_dict_from_jax(variables)


def test_checkpoint_serves_a_tracking_shell(shells, tmp_path):
    """A tracking checkpoint of the port rebuilds a TrackingShell through
    ``load_shell`` and ``Predictor(checkpoint=...)``."""
    _, _, port = shells
    base = dict(port_factory.SHUFFLENETV2K_OPTIONS)
    path = str(tmp_path / 'tracking')
    checkpoint.save(path, state_dict=port.state_dict(), meta={
        'base_name': 'shufflenetv2k16', 'epoch': 0,
        'backbone_options': {'shufflenetv2k': base},
        'head_metas': [checkpoint.headmeta_to_dict(m)
                       for m in port.head_metas]})
    # a full-width k16 with the narrow weights would not load: build the
    # narrow backbone through the registry
    with restored_statics():
        saved = dict(port_factory.BASE_FACTORIES)
        port_factory.BASE_FACTORIES['shufflenetv2k16'] = \
            lambda: basenetworks.ShuffleNetV2K(*NARROW)
        try:
            model, meta = checkpoint.load_shell(path)
            predictor = Predictor(checkpoint=path, device='cpu')
        finally:
            port_factory.BASE_FACTORIES.clear()
            port_factory.BASE_FACTORIES.update(saved)
    assert isinstance(model, TrackingShell)
    assert isinstance(predictor.model, TrackingShell)
    assert [type(m).__name__ for m in predictor.head_metas] == [
        'TSingleImageCif', 'TSingleImageCaf', 'Tcaf']
    for k, v in port.state_dict().items():
        torch.testing.assert_close(model.state_dict()[k], v)


def test_tracking_predictor_refuses_engines_and_bf16(shells):
    _, _, port = shells
    for kw in ({'backbone_engine': 'folded'}, {'bf16': True}):
        with pytest.raises(ValueError, match='module graph'):
            Predictor(model=port, device='cpu', **kw)


# -- the decoder factory -----------------------------------------------------

@pytest.mark.parametrize('requested', [None, ['trackingpose:0'], ['cifcaf'],
                                       ['cifcaf:0', 'trackingpose']])
def test_decoder_factory_matches_jax(requested):
    ours = port_tracking_decoder(STRIDE, requested=requested)
    ref = jax_tracking_decoder(STRIDE, requested=requested)
    names = [type(d).__name__ for d in ours.decoders]
    assert names == [type(d).__name__ for d in ref.decoders]
    assert names == {None: ['CifCaf', 'TrackingPose'],
                     'trackingpose:0': ['TrackingPose'],
                     'cifcaf': ['CifCaf']}.get(
        requested and requested[0], ['CifCaf', 'TrackingPose'])
    assert type(ours).__name__ == type(ref).__name__ == 'Multi'
    for o, r in zip(ours.decoders, ref.decoders):
        o_cfg = getattr(o, 'pose_generator', o).config
        r_cfg = getattr(r, 'pose_generator', r).config
        assert dataclasses.asdict(o_cfg) == dataclasses.asdict(r_cfg)
    tracking = [d for d in ours.decoders if type(d).__name__ ==
                'TrackingPose']
    for d in tracking:
        assert len(d.tracking_cif_meta.keypoints) == 34
        assert len(d.tracking_caf_meta.skeleton) == 19 + 17


def test_decoder_factory_dense_metas_match_jax():
    """With the dense CAF head there is no (cif, caf, tcaf) triple: CifCaf
    alone, in both packages."""
    with restored_statics(CocoKp, JaxCocoKp):
        CocoKp.with_dense = JaxCocoKp.with_dense = True
        ours = port_decoder.decoders(port_tracking_metas(STRIDE))
        ref = jax_decoder.factory.decoders(jax_tracking_metas(STRIDE))
    assert [type(d).__name__ for d in ours] == \
        [type(d).__name__ for d in ref] == ['CifCaf']


def test_posesimilarity_is_not_auto_instantiated():
    for build in (port_tracking_decoder, jax_tracking_decoder):
        with pytest.raises(ValueError, match='no decoders found'):
            build(STRIDE, requested=['posesimilarity'])
    assert len(port_decoder.PoseSimilarity.from_metas(
        port_tracking_metas(STRIDE))) == 1


def test_decoder_flags_match_jax():
    """Every registry flag parses alike; ``--decode-device`` raises in the
    port (ROADMAP A5); ``--profile-decoder`` wraps each decoder."""
    argv = ['--cif-th', '0.2', '--caf-th', '0.25', '--decoder-workers', '2',
            '--trackingpose-track-recovery', '--posesimilarity-distance',
            'oks', '--posesimilarity-oks-inflate', '2.0']
    parsed = {}
    for name, decoder, factory in (('jax', jax_decoder, jax_decoder.factory),
                                   ('port', port_decoder, port_decoder)):
        parser = argparse.ArgumentParser()
        with restored_statics(*decoder.DECODERS, decoder.pose_distance.Oks):
            factory.cli(parser)
            factory.configure(parser.parse_args(argv))
            parsed[name] = (
                decoder.CifCaf.cifhr_threshold, decoder.CifCaf.caf_score_th,
                decoder.TrackingPose.track_recovery,
                decoder.TrackingPose.single_seed,
                decoder.PoseSimilarity.distance_type.__name__,
                decoder.pose_distance.Oks.inflate)
    assert parsed['jax'] == parsed['port'] == (0.2, 0.25, True, False, 'Oks',
                                               2.0)
    parser = argparse.ArgumentParser()
    with restored_statics(*port_decoder.DECODERS):
        port_decoder.cli(parser)
        with pytest.raises(NotImplementedError, match='ROADMAP A5'):
            port_decoder.configure(parser.parse_args(['--decode-device',
                                                      '1']))
    multi = port_tracking_decoder(STRIDE, flags=('--profile-decoder',))
    assert all(type(d.batch_decode).__name__ == 'Profiler'
               for d in multi.decoders)
