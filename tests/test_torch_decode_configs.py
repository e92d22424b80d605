"""Every CifCaf decoder configuration of the PyTorch port against the JAX
package.

Two levels, on ``field_fixtures`` scenes jittered to be tie-free, with two
CAF edges damped (``torch_port_helpers.weaken``) so that the default
decode misses joints that force-complete, ``block_joints`` and the dense
connections act on:

- the ops, each fed the same inputs as its JAX counterpart: the lazy
  CifHr (``cif_hr_cells``, ``eval_cells``; atol 1e-6), ``cif_seeds`` and
  ``caf_scored`` under their options (indices and flags exact, floats to
  1e-5), the initial-pose occupancy (exact), the greedy, ``block_joints``
  and ``record_order`` growth, ``grow_from_poses`` and
  ``flood_fill_poses`` (poses to 1e-5 and one float32 rounding of
  coordinates up to 256 px, commit arrays exact);
- the port's decoders built from the same CLI flags as JAX's, under each
  configuration of ``torch_port_helpers.CONFIGS``, against JAX's decodes
  of the golden scene (held against fresh JAX decodes by
  ``test_torch_decode_golden.py``): poses within the tie-free gate (equal
  counts and visibility, xy within 1e-3 px, confidences within 2e-3),
  equal ``json_data()``, equal decoding orders and ids; force-complete on
  the lazy CifHr through the crowd tier's escalation against a fresh JAX
  decode; and the flag mapping itself.
"""

import argparse
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from openpifpaf_tpu import decoder as jax_decoder_mod
from openpifpaf_tpu.ops import caf_scored as jax_caf
from openpifpaf_tpu.ops import cifhr as jax_cifhr
from openpifpaf_tpu.ops import grow as jax_grow
from openpifpaf_tpu.ops import nms as jax_nms
from openpifpaf_tpu.ops import seeds as jax_seeds
from openpifpaf_tpu.plugins.coco.constants import COCO_PERSON_SKELETON
from openpifpaf_tpu_torch import decoder as port_decoder_mod
from openpifpaf_tpu_torch.ops import caf_scored, cifhr, grow, seeds

import torch_port_helpers as helpers

STRIDE = 8
SKELETON = np.asarray(COCO_PERSON_SKELETON)
#: float tolerance of the op-level comparisons
ATOL = 1e-5
#: and of the grown poses' coordinates: XLA and torch round the blends
#: apart by an ulp, 1.5e-5 at 128-256 px
GROW_RTOL = 1e-6


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    helpers.one_torch_thread()


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


@pytest.fixture(scope='module')
def scene():
    """(cif, weakened caf, dense caf) of the 3-person scene at stride 8,
    with its hi-res shape and the JAX intermediate values the ops read."""
    cif, caf, dcaf = helpers.row_scene(3, (169, 257), STRIDE, height=90.0,
                                       seed=0, with_dense=True)
    caf = helpers.weaken(caf)
    hr_shape = ((cif.shape[2] - 1) * STRIDE + 1,
                (cif.shape[3] - 1) * STRIDE + 1)
    out = dict(cif=cif, caf=caf, dcaf=dcaf, hr_shape=hr_shape)
    with helpers.jax_f32():
        cells, _, _, overflow = jax_cifhr.cif_hr_cells(jnp.asarray(cif),
                                                       STRIDE)
        out['cells'], out['cells_overflow'] = _np(cells), bool(overflow)
        hr = jax_cifhr.cif_hr(jnp.asarray(cif), STRIDE, impl='dense')
        out['hr'] = np.asarray(hr)
        s = jax_seeds.cif_seeds(jnp.asarray(cif), hr, STRIDE)
        out['seeds'] = _np(s)
        keep_idx, keep_valid = jax_seeds.seed_nms(s, 17, hr_shape, n_keep=96)
        lanes = {k: v[keep_idx] for k, v in s.items()}
        lanes['v'] = jnp.where(keep_valid, lanes['v'], 0.0)
        out['lanes'] = _np(lanes)
        out['cands'] = _np(jax_caf.caf_scored(
            jnp.asarray(caf), hr, STRIDE, SKELETON, n_candidates=256))
        out['low_cands'] = _np(jax_caf.caf_scored(
            jnp.asarray(caf), hr, STRIDE, SKELETON, score_th=0.001,
            n_candidates=1024))
        out['poses'] = np.asarray(jax_grow.grow_poses(
            _j(out['cands']), jax_grow.make_skeleton_graph(17, SKELETON),
            lanes))
    return out


def _kept(poses):
    """Partial poses: every lane's first joints dropped in turn, two lanes
    emptied, so that growth starts from varied frontiers."""
    poses = np.array(poses, copy=True)
    live = np.nonzero(poses[:, :, 0].sum(axis=1) > 0)[0]
    for n, lane in enumerate(live):
        poses[lane, (np.arange(17) + n) % 17 < 9] = 0.0
    poses[live[:2]] = 0.0
    return poses


# -- lazy CifHr --------------------------------------------------------------

def test_cif_hr_cells_match_jax(scene):
    cells, hr_h, hr_w, overflow = cifhr.cif_hr_cells(_t(scene['cif']), STRIDE)
    assert (hr_h, hr_w) == scene['hr_shape']
    assert bool(overflow) == scene['cells_overflow']
    assert (scene['cells']['w'] > 0).sum() > 100
    for k, ref in scene['cells'].items():
        np.testing.assert_allclose(cells[k].numpy(), ref, atol=1e-6, rtol=0,
                                   err_msg=k)


def _queries(scene, n, seed):
    """(17, n) query points: half near each field's cells, half anywhere in
    and around the map, some of them exactly on half pixels."""
    rng = np.random.RandomState(seed)
    hs, ws = scene['hr_shape']
    x = rng.uniform(-3.0, ws + 3.0, (17, n)).astype(np.float32)
    y = rng.uniform(-3.0, hs + 3.0, (17, n)).astype(np.float32)
    near = rng.randint(0, 24, (17, n // 2))   # the strongest cells
    cells = scene['cells']
    x[:, :n // 2] = np.take_along_axis(cells['x'], near, 1) \
        + rng.uniform(-4.0, 4.0, near.shape)
    y[:, :n // 2] = np.take_along_axis(cells['y'], near, 1) \
        + rng.uniform(-4.0, 4.0, near.shape)
    x[:, -8:] = np.floor(x[:, -8:]) + 0.5
    return x, y


def test_eval_cells_matches_jax(scene):
    x, y = _queries(scene, 300, seed=1)
    hs, ws = scene['hr_shape']
    with helpers.jax_f32():
        ref = np.asarray(jax_cifhr.eval_cells(
            _j(scene['cells']), jnp.asarray(x), jnp.asarray(y), hs=hs, ws=ws,
            default=-1.0))
    out = cifhr.eval_cells({k: _t(v) for k, v in scene['cells'].items()},
                           _t(x), _t(y), hs=hs, ws=ws, default=-1.0)
    assert (ref > 0).sum() > 50 and (ref == -1.0).sum() > 10
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=0)


def test_lazy_equals_dense_map_lookup(scene):
    """'lazy' against 'dense' + ``cifhr_lookup`` at the same points: the
    port's two CifHr paths agree up to float summation order."""
    x, y = _queries(scene, 300, seed=2)
    hs, ws = scene['hr_shape']
    cif = _t(scene['cif'])
    cells, *_ = cifhr.cif_hr_cells(cif, STRIDE)
    lazy = cifhr.eval_cells(cells, _t(x), _t(y), hs=hs, ws=ws)
    hr = cifhr.cif_hr(cif, STRIDE, impl='dense')
    f = torch.arange(17)[:, None].expand(17, x.shape[1])
    dense = cifhr.cifhr_lookup(hr, f, _t(x), _t(y))
    assert (dense > 0).sum() > 50
    np.testing.assert_allclose(lazy.numpy(), dense.numpy(), atol=1e-6,
                               rtol=0)


# -- seeds and CAF scoring ---------------------------------------------------

SEED_CASES = {
    'no_rescore': dict(rescore=False),
    'nms': dict(nms=True),
    'blob_compact': dict(blob_compact=True),
    # confidences on a 0.1 grid: plateaus whose ties blob_compact breaks
    'blob_compact_plateaus': dict(blob_compact=True),
    'lazy': dict(hr_cells=True),
}


@pytest.mark.parametrize('case', list(SEED_CASES))
def test_cif_seeds_options_match_jax(scene, case):
    kw = dict(SEED_CASES[case])
    cif = scene['cif'].copy()
    if case.endswith('plateaus'):
        cif[:, 1] = np.round(cif[:, 1] * 10.0) / 10.0
    hr = scene['hr']
    if kw.pop('hr_cells', False):
        hr = None
        kw.update(hr_shape=scene['hr_shape'])
        jax_kw = dict(kw, hr_cells=_j(scene['cells']))
        port_kw = dict(kw, hr_cells={k: _t(v)
                                     for k, v in scene['cells'].items()})
    else:
        jax_kw = port_kw = kw
    with helpers.jax_f32():
        ref, ref_cand = jax_seeds.cif_seeds(
            jnp.asarray(cif), None if hr is None else jnp.asarray(hr),
            STRIDE, n_seeds=64, return_candidates=True, **jax_kw)
    out, cand = seeds.cif_seeds(_t(cif), None if hr is None else _t(hr),
                                STRIDE, n_seeds=64, return_candidates=True,
                                **port_kw)
    ref = _np(ref)
    assert (ref['v'] > 0).sum() > 10
    np.testing.assert_array_equal(out['f'].numpy(), ref['f'])
    for k in ('v', 'x', 'y', 's'):
        np.testing.assert_allclose(out[k].numpy(), ref[k], atol=ATOL,
                                   rtol=0, err_msg=k)
    np.testing.assert_array_equal(cand['dropped'].numpy(),
                                  np.asarray(ref_cand['dropped']))


def test_blob_compact_keeps_one_cell_per_plateau():
    """A 3x3 plateau and a 2-cell plateau give one peak each, the cell of
    the largest linear index; the ``nms`` ablation keeps every tie."""
    conf = torch.zeros((1, 6, 7))
    conf[0, 1:4, 1:4] = 0.8
    conf[0, 4, 5:7] = 0.6
    live = conf[0] > 0.0
    peaks = seeds.local_peaks(conf, break_ties=True)[0] & live
    assert torch.nonzero(peaks).tolist() == [[3, 3], [4, 6]]
    ties = seeds.local_peaks(conf, break_ties=False)[0] & live
    assert int(ties.sum()) == 11


CAF_CASES = {
    'no_rescore': dict(rescore=False, n_candidates=256),
    'lazy': dict(hr_cells=True, n_candidates=256),
    'lazy_full_planes': dict(hr_cells=True, n_candidates=0),
}


@pytest.mark.parametrize('case', list(CAF_CASES))
def test_caf_scored_options_match_jax(scene, case):
    kw = dict(CAF_CASES[case])
    hr = scene['hr']
    jax_kw, port_kw = dict(kw), dict(kw)
    if kw.get('hr_cells'):
        hr = None
        for d, cells in ((jax_kw, _j(scene['cells'])),
                         (port_kw, {k: _t(v)
                                    for k, v in scene['cells'].items()})):
            d.update(hr_cells=cells, hr_shape=scene['hr_shape'])
    with helpers.jax_f32():
        ref, ref_over = jax_caf.caf_scored(
            jnp.asarray(scene['caf']), None if hr is None else jnp.asarray(hr),
            STRIDE, SKELETON, return_overflow=True, **jax_kw)
    out, over = caf_scored.caf_scored(
        _t(scene['caf']), None if hr is None else _t(hr), STRIDE, SKELETON,
        return_overflow=True, **port_kw)
    assert bool(over) == bool(ref_over)
    ref = _np(ref)
    assert (ref['c'] > 0).sum() > 100
    np.testing.assert_array_equal(out['c'].numpy() > 0, ref['c'] > 0)
    for k, r in ref.items():
        np.testing.assert_allclose(out[k].numpy(), r, atol=ATOL, rtol=0,
                                   err_msg=k)


# -- initial-pose occupancy and lanes ----------------------------------------

def test_initial_pose_occupancy_equals_mark_occupancy(scene):
    """The port takes ``seeds.occupancy_grid`` for JAX's
    ``nms.mark_occupancy`` of initial poses: the two grids are equal."""
    poses = _kept(scene['poses'])
    poses[3:6, :, 3] *= 3.0      # wider windows, clipped at the borders
    poses[3, :, 1] = -20.0
    ref = np.asarray(jax_nms.mark_occupancy(jnp.asarray(poses),
                                            scene['hr_shape']))
    out = seeds.occupancy_grid(_t(poses), scene['hr_shape'])
    assert ref.sum() > 100
    np.testing.assert_array_equal(out.numpy(), ref)


def test_seed_nms_with_initial_occupancy_matches_jax(scene):
    occ0 = np.asarray(jax_nms.mark_occupancy(
        jnp.asarray(scene['poses'][:2]), scene['hr_shape']))
    with helpers.jax_f32():
        ref = jax_seeds.seed_nms(_j(scene['seeds']), 17, scene['hr_shape'],
                                 n_keep=96, occ0=jnp.asarray(occ0))
    out = seeds.seed_nms({k: _t(v) for k, v in scene['seeds'].items()}, 17,
                         scene['hr_shape'], n_keep=96, occ0=_t(occ0))
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    plain = jax_seeds.seed_nms(_j(scene['seeds']), 17, scene['hr_shape'],
                               n_keep=96)
    assert np.asarray(ref[1]).sum() < np.asarray(plain[1]).sum()


def test_seed_rank_dedup_with_initial_lanes_matches_jax(scene):
    lanes = scene['lanes']
    initial = _kept(scene['poses'])[:8]
    poses = np.concatenate([initial, scene['poses']])
    args = (lanes['f'], lanes['x'], lanes['y'], lanes['v'] > 0.0)
    ref = np.asarray(jax_seeds.seed_rank_dedup(
        jnp.asarray(poses), *(jnp.asarray(a) for a in args),
        scene['hr_shape'], n_initial=8))
    out = seeds.seed_rank_dedup(_t(poses), *(_t(a) for a in args),
                                scene['hr_shape'], n_initial=8)
    assert ref[:8].all() and 0 < ref[8:].sum() < (lanes['v'] > 0).sum()
    np.testing.assert_array_equal(out.numpy(), ref)


# -- growth -------------------------------------------------------------------

def _dense_random_candidates():
    """Candidates of every directed edge in one small window (almost every
    edge connects from almost any joint) and 24 seed lanes, 4 empty."""
    rng = np.random.RandomState(5)
    n_dir, n_cand, n_lanes = 2 * len(SKELETON), 48, 24
    cands = {k: rng.uniform(28.0, 36.0, (n_dir, n_cand)).astype(np.float32)
             for k in ('sx', 'sy', 'tx', 'ty')}
    cands['ts'] = rng.uniform(8.0, 14.0, (n_dir, n_cand)).astype(np.float32)
    cands['c'] = np.where(rng.rand(n_dir, n_cand) < 0.7,
                          rng.uniform(0.3, 1.0, (n_dir, n_cand)),
                          0.0).astype(np.float32)
    lanes = {'f': rng.randint(0, 17, n_lanes),
             'v': rng.uniform(0.3, 1.0, n_lanes).astype(np.float32),
             'x': rng.uniform(28.0, 36.0, n_lanes).astype(np.float32),
             'y': rng.uniform(28.0, 36.0, n_lanes).astype(np.float32),
             's': rng.uniform(8.0, 14.0, n_lanes).astype(np.float32)}
    lanes['v'][-4:] = 0.0
    return cands, lanes


GROW_CASES = {
    'greedy_max': dict(greedy=True, only_max=True),
    'block_record': dict(block_joints=True, record_order=True),
    'greedy_block_record': dict(greedy=True, block_joints=True,
                                record_order=True),
}


def _assert_grown(out, ref, record):
    if record:
        (out, ce, cs), (ref, rce, rcs) = out, ref
        np.testing.assert_array_equal(ce.numpy(), np.asarray(rce))
        np.testing.assert_array_equal(cs.numpy(), np.asarray(rcs))
        assert (np.asarray(rce) >= 0).sum() > 20
    ref = np.asarray(ref)
    np.testing.assert_array_equal(out.numpy()[:, :, 0] > 0, ref[:, :, 0] > 0)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=GROW_RTOL)


@pytest.mark.parametrize('data', ['scene', 'dense_random'])
@pytest.mark.parametrize('case', list(GROW_CASES))
def test_grow_poses_options_match_jax(scene, case, data):
    kw = GROW_CASES[case]
    if data == 'scene':
        cands, lanes = scene['cands'], scene['lanes']
    else:
        cands, lanes = _dense_random_candidates()
    with helpers.jax_f32():
        ref = jax_grow.grow_poses(_j(cands),
                                  jax_grow.make_skeleton_graph(17, SKELETON),
                                  _j(lanes), **kw)
    out = grow.grow_poses({k: _t(v) for k, v in cands.items()},
                          grow.make_skeleton_graph(17, SKELETON),
                          {k: _t(v) for k, v in lanes.items()}, **kw)
    _assert_grown(out, ref, kw.get('record_order'))


@pytest.mark.parametrize('greedy', [False, True])
def test_grow_from_poses_matches_jax(scene, greedy):
    """The force-complete pass: partial poses (two lanes empty) on
    low-threshold candidates, no reverse match, wide filter."""
    poses = _kept(scene['poses'])
    kw = dict(keypoint_threshold=0.0, keypoint_threshold_rel=0.0,
              reverse_match=False, filter_sigmas=4.0, greedy=greedy,
              record_order=True)
    with helpers.jax_f32():
        ref = jax_grow.grow_from_poses(
            _j(scene['low_cands']), jax_grow.make_skeleton_graph(17, SKELETON),
            jnp.asarray(poses), **kw)
    out = grow.grow_from_poses(
        {k: _t(v) for k, v in scene['low_cands'].items()},
        grow.make_skeleton_graph(17, SKELETON), _t(poses), **kw)
    _assert_grown(out, ref, True)
    assert not out[0][np.nonzero(poses[:, :, 0].sum(1) == 0)[0]].any()


def test_flood_fill_poses_matches_jax(scene):
    poses = _kept(scene['poses'])
    ref = np.asarray(jax_grow.flood_fill_poses(
        jax_grow.make_skeleton_graph(17, SKELETON), jnp.asarray(poses)))
    graph = grow.make_skeleton_graph(17, SKELETON)
    out = grow.flood_fill_poses(graph, _t(poses))
    assert (ref[:, :, 0] == np.float32(1e-5)).sum() > 20
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(
        grow.flood_fill_pose(graph, _t(poses[5])).numpy(), ref[5])


# -- the whole decoder ---------------------------------------------------------

def _assert_same_annotations(out, ref, json=True):
    """The pose gate (and equal ``json_data()``) between two lists of
    annotations, with equal ids."""
    assert len(out) == len(ref) >= 1
    helpers.assert_pose_gate(list(helpers.pose_rows(out)),
                             list(helpers.pose_rows(ref)))
    if json:
        assert [a.json_data() for a in out] == [a.json_data() for a in ref]
    assert [a.id_ for a in out] == [a.id_ for a in ref]


@pytest.fixture(scope='module')
def golden():
    return np.load(helpers.GOLDEN)


@pytest.mark.parametrize('name', [c for c in helpers.CONFIGS
                                  if c != 'default'])
def test_decoder_config_matches_jax(golden, name):
    """The port's decoder, built from the configuration's CLI flags, on
    the damped 3-person golden scene with the lazy CifHr (JAX's default)
    against JAX's decode of it in the golden file (held against fresh JAX
    decodes by ``test_torch_decode_golden.py``): the pose gate, equal
    ``json_data()``, decoding orders and ids. 'tracked' decodes a batch of
    two: the image with its initial poses and, beside it, without."""
    key = 'sparse_default' if name == 'lazy' else f'sparse_{name}'
    flags, overrides = helpers.CONFIGS[name]
    dec = helpers.port_decoder(helpers.GOLDEN_STRIDE,
                               flags + helpers.GOLDEN_SPARSE_FLAGS,
                               dict(overrides, cifhr_impl='lazy'))
    fields, initial = helpers.golden_inputs(golden, 'sparse', name, key,
                                            'cpu')
    keys = [key]
    if name == 'tracked':
        fields = [torch.cat([f, f]) for f in fields]
        initial = initial + [[]]
        keys.append('sparse_default')
    out = dec.batch_decode(fields, initial)
    assert dec.last_escalated == []
    for anns, k in zip(out, keys):
        ids = golden[f'{k}_ids'] if f'{k}_ids' in golden.files else ()
        ref = helpers.annotations_from_rows(golden[f'{k}_poses'],
                                            [i if i >= 0 else None
                                             for i in ids])
        _assert_same_annotations(anns, ref)
        if f'{k}_order' in golden.files:
            assert all(a.decoding_order for a in anns)
            np.testing.assert_array_equal(helpers.order_rows(anns),
                                          golden[f'{k}_order'])
    if name == 'tracked':
        assert sorted(a.id_ for a in out[0] if a.id_ is not None) == \
            sorted(helpers.TRACKED_IDS)
        assert all(a.id_ is None for a in out[1])


def test_force_complete_lazy_crowd_escalation_matches_jax():
    """Force-complete on the lazy CifHr, with the decoding order, against
    a fresh JAX decode: a crowded image escalates to the crowd tier, whose
    completion pass keeps the full candidate planes; the sparse image
    beside it does not. No ``json_data()`` equality here: a bbox rounded
    to 0.01 px can differ at a rounding boundary."""
    scenes = [helpers.sparse_scene(seed=0), helpers.crowd_scene()]
    fields = [np.stack([helpers.weaken(s[i]) if i else s[i]
                        for s in scenes]) for i in (0, 1)]
    flags, _ = helpers.CONFIGS['force_complete']
    overrides = dict(cifhr_impl='lazy', export_decoding_order=True)
    with helpers.jax_f32():
        ref = helpers.jax_decoder(STRIDE, flags, overrides).batch_decode(
            fields)
    dec = helpers.port_decoder(STRIDE, flags, overrides)
    out = dec.batch_decode([_t(f) for f in fields])
    assert dec.last_escalated == [1]
    assert len(ref[1]) >= 8
    assert all((a.data[:, 2] > 0).all() for a in out[1])
    for ours, theirs in zip(out, ref):
        _assert_same_annotations(ours, theirs, json=False)
        np.testing.assert_array_equal(helpers.order_rows(ours),
                                      helpers.order_rows(theirs))


FLAG_SETS = {
    'all': ['--cif-th', '0.25', '--caf-th', '0.35',
            '--force-complete-pose', '--force-complete-caf-th', '0.01',
            '--nms-before-force-complete', '--cifcaf-block-joints',
            '--ablation-cifseeds-nms', '--ablation-cifseeds-no-rescore',
            '--ablation-caf-no-rescore', '--ablation-independent-kp',
            '--greedy', '--connection-method', 'max', '--no-reverse-match',
            '--decoder-seeds', '128', '--decoder-poses', '48',
            '--decoder-crowd-poses', '200'],
    'force_complete': ['--force-complete-pose', '--seed-threshold', '0.1',
                       '--keypoint-threshold', '0.2',
                       '--instance-threshold', '0.2'],
    'thresholds': ['--seed-threshold', '0.1', '--keypoint-threshold', '0.2',
                   '--keypoint-threshold-rel', '0.4'],
    'dense': ['--dense-connections', '--ablation-cifseeds-no-rescore'],
    'dense_coupling': ['--dense-connections', '0.1', '--greedy'],
}


@pytest.mark.parametrize('flags', list(FLAG_SETS))
def test_flag_mapping_matches_jax(flags):
    """The same argv gives equal decoder configs (and statics) in both
    packages."""
    argv = FLAG_SETS[flags]
    dense = '--dense-connections' in argv
    statics = {}
    for name, mod, cifcaf, dense_cls in (
            ('jax', jax_decoder_mod.factory, jax_decoder_mod.CifCaf,
             jax_decoder_mod.CifCafDense),
            ('port', port_decoder_mod, port_decoder_mod.CifCaf,
             port_decoder_mod.CifCafDense)):
        parser = argparse.ArgumentParser()
        classes = jax_decoder_mod.factory.DECODERS if name == 'jax' \
            else (cifcaf, dense_cls)
        with helpers.restored_statics(*classes):
            mod.cli(parser)
            mod.configure(parser.parse_args(argv))
            statics[name] = dict(
                {k: getattr(cifcaf, k) for k in vars(port_decoder_mod.CifCaf)
                 if not k.startswith('_')
                 and not callable(getattr(cifcaf, k))},
                dense_coupling=dense_cls.dense_coupling)
    assert statics['jax'] == statics['port']
    ours = helpers.port_decoder(STRIDE, argv)
    theirs = helpers.jax_decoder(STRIDE, argv)
    assert type(ours).__name__ == type(theirs).__name__ == \
        ('CifCafDense' if dense else 'CifCaf')
    if dense:
        ours, theirs = ours.cifcaf, theirs.cifcaf
        assert ours.caf_meta.decoder_confidence_scales == \
            theirs.caf_meta.decoder_confidence_scales
        np.testing.assert_array_equal(ours.skeleton, theirs.skeleton)
    assert dataclasses.asdict(ours.config) == \
        dataclasses.asdict(theirs.config)
    assert dataclasses.asdict(ours._crowd_config()) == \
        dataclasses.asdict(theirs._crowd_config())


def test_factory_without_dense_head_raises():
    """``--dense-connections`` on a model without the dense CAF head finds
    no decoder, as JAX's factory does."""
    parser = argparse.ArgumentParser()
    with helpers.restored_statics(port_decoder_mod.CifCaf,
                                  port_decoder_mod.CifCafDense):
        port_decoder_mod.cli(parser)
        port_decoder_mod.configure(parser.parse_args(['--dense-connections']))
        with pytest.raises(ValueError, match='dense Caf head'):
            port_decoder_mod.factory(helpers.port_metas(STRIDE))
