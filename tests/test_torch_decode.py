"""CifCaf decode of the PyTorch port against the JAX package.

Two levels, on ``field_fixtures`` scenes jittered to be tie-free:

- the ops (``cif_seeds``, ``seed_nms``, ``caf_scored``, ``grow_poses``,
  ``seed_rank_dedup``, ``nms_keypoints``), each fed the same inputs as
  its JAX counterpart (the JAX pipeline's intermediate values);
- the port's ``CifCaf`` at batch 1 and 2 against JAX's ``CifCaf`` with
  the materialised (``'dense'``) and the default lazy CifHr, including a
  scene that escalates to the crowd tier.

Poses are held to the tie-free gate of ``test_adversarial_parity.py``:
equal counts and visibility, locations within 1e-3 px, confidences within
2e-3. The op-level float tolerances are stated at each comparison.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from openpifpaf_tpu.ops import caf_scored as jax_caf
from openpifpaf_tpu.ops import cifhr as jax_cifhr
from openpifpaf_tpu.ops import grow as jax_grow
from openpifpaf_tpu.ops import nms as jax_nms
from openpifpaf_tpu.ops import seeds as jax_seeds
from openpifpaf_tpu.plugins.coco.constants import COCO_PERSON_SKELETON
from openpifpaf_tpu_torch.decoder import CifCaf
from openpifpaf_tpu_torch.ops import caf_scored, grow, nms, seeds
from openpifpaf_tpu_torch.ops.decode_cifcaf import CifCafDecoderConfig

import torch_port_helpers as helpers

STRIDE = 8
SKELETON = np.asarray(COCO_PERSON_SKELETON)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    helpers.one_torch_thread()


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


@pytest.fixture(scope='module')
def stages():
    """Every stage's inputs and JAX outputs on a sparse scene, with the
    JAX materialised CifHr map as the shared starting point."""
    cif, caf = helpers.sparse_scene(seed=0)
    hr_shape = ((cif.shape[2] - 1) * STRIDE + 1,
                (cif.shape[3] - 1) * STRIDE + 1)
    graph = jax_grow.make_skeleton_graph(17, SKELETON)
    out = {'cif': cif, 'caf': caf, 'hr_shape': hr_shape}
    with helpers.jax_f32():
        hr = jax_cifhr.cif_hr(jnp.asarray(cif), STRIDE, impl='dense')
        out['hr'] = np.asarray(hr)
        s, cand = jax_seeds.cif_seeds(jnp.asarray(cif), hr, STRIDE,
                                      return_candidates=True)
        out['seeds'], out['cand'] = _np(s), _np(cand)
        keep_idx, keep_valid = jax_seeds.seed_nms(s, 17, hr_shape, n_keep=96)
        out['keep_idx'] = np.asarray(keep_idx)
        out['keep_valid'] = np.asarray(keep_valid)
        lanes = {k: v[keep_idx] for k, v in s.items()}
        lanes['v'] = jnp.where(keep_valid, lanes['v'], 0.0)
        out['lanes'] = _np(lanes)
        cands = jax_caf.caf_scored(jnp.asarray(caf), hr, STRIDE, SKELETON,
                                   n_candidates=256)
        out['cands'] = _np(cands)
        poses = jax_grow.grow_poses(cands, graph, lanes)
        out['poses'] = np.asarray(poses)
        accept = jax_seeds.seed_rank_dedup(
            poses, lanes['f'], lanes['x'], lanes['y'], lanes['v'] > 0.0,
            hr_shape)
        out['accept'] = np.asarray(accept)
        deduped = jnp.where(accept[:, None, None], poses, 0.0)
        out['deduped'] = np.asarray(deduped)
        out['nms'] = tuple(np.asarray(a) for a in
                           jax_nms.nms_keypoints(deduped, hr_shape))
        out['occ'] = np.asarray(jax_seeds.occupancy_grid(deduped, hr_shape))
    return out


def test_cif_seeds_matches_jax(stages):
    out, cand = seeds.cif_seeds(_t(stages['cif']), _t(stages['hr']), STRIDE,
                                return_candidates=True)
    ref = stages['seeds']
    assert (ref['v'] > 0).sum() > 20
    np.testing.assert_array_equal(out['f'].numpy(), ref['f'])
    for k in ('v', 'x', 'y', 's'):
        # v is 0.9 * hr + 0.1 * c: XLA may contract it into one FMA
        np.testing.assert_allclose(out[k].numpy(), ref[k], atol=1e-6,
                                   rtol=0)
    np.testing.assert_array_equal(cand['dropped'].numpy(),
                                  stages['cand']['dropped'])


def test_seed_nms_matches_jax(stages):
    keep_idx, keep_valid = seeds.seed_nms(
        {k: _t(v) for k, v in stages['seeds'].items()}, 17,
        stages['hr_shape'], n_keep=96)
    np.testing.assert_array_equal(keep_idx.numpy(), stages['keep_idx'])
    np.testing.assert_array_equal(keep_valid.numpy(), stages['keep_valid'])
    assert stages['keep_valid'].sum() > 3


def test_caf_scored_matches_jax(stages):
    out, overflow = caf_scored.caf_scored(
        _t(stages['caf']), _t(stages['hr']), STRIDE, SKELETON,
        n_candidates=256, return_overflow=True)
    assert not bool(overflow)
    for k, ref in stages['cands'].items():
        # c' = c * (0.1 + 0.9 * hr): one rounding apart at most
        np.testing.assert_allclose(out[k].numpy(), ref, atol=1e-6, rtol=0)


def test_grow_poses_matches_jax(stages):
    graph = grow.make_skeleton_graph(17, SKELETON)
    poses = grow.grow_poses({k: _t(v) for k, v in stages['cands'].items()},
                            graph,
                            {k: _t(v) for k, v in stages['lanes'].items()})
    ref = stages['poses']
    assert (ref[:, :, 0] > 0).sum() > 3 * 17
    np.testing.assert_array_equal(poses.numpy()[:, :, 0] > 0,
                                  ref[:, :, 0] > 0)
    # exp() and the blend's products round differently in XLA and torch
    np.testing.assert_allclose(poses.numpy(), ref, atol=1e-4, rtol=0)


def test_grow_poses_matches_jax_on_dense_random_candidates():
    """Candidates of every directed edge crowd one small window, so that
    almost every edge connects from almost any joint: a cache slot written
    from the wrong source joint, or twice, changes the poses."""
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
    lanes['v'][-4:] = 0.0  # empty lanes stay all-zero
    with helpers.jax_f32():
        ref = np.asarray(jax_grow.grow_poses(
            {k: jnp.asarray(v) for k, v in cands.items()},
            jax_grow.make_skeleton_graph(17, SKELETON),
            {k: jnp.asarray(v) for k, v in lanes.items()}))
    poses = grow.grow_poses({k: _t(v) for k, v in cands.items()},
                            grow.make_skeleton_graph(17, SKELETON),
                            {k: _t(v) for k, v in lanes.items()}).numpy()
    assert (ref[:-4, :, 0] > 0).sum() > 10 * (n_lanes - 4)
    assert not ref[-4:].any()
    np.testing.assert_array_equal(poses[:, :, 0] > 0, ref[:, :, 0] > 0)
    np.testing.assert_allclose(poses, ref, atol=1e-4, rtol=0)


def test_seed_rank_dedup_matches_jax(stages):
    lanes = {k: _t(v) for k, v in stages['lanes'].items()}
    accept = seeds.seed_rank_dedup(_t(stages['poses']), lanes['f'],
                                   lanes['x'], lanes['y'], lanes['v'] > 0.0,
                                   stages['hr_shape'])
    np.testing.assert_array_equal(accept.numpy(), stages['accept'])
    occ = seeds.occupancy_grid(_t(stages['deduped']), stages['hr_shape'])
    np.testing.assert_array_equal(occ.numpy(), stages['occ'])


def test_nms_keypoints_matches_jax(stages):
    poses, keep, order = nms.nms_keypoints(_t(stages['deduped']),
                                           stages['hr_shape'])
    ref_poses, ref_keep, ref_order = stages['nms']
    assert ref_keep.sum() == 3
    np.testing.assert_array_equal(keep.numpy(), ref_keep)
    np.testing.assert_array_equal(order.numpy(), ref_order)
    np.testing.assert_allclose(poses.numpy(), ref_poses, atol=1e-6, rtol=0)


def _port_poses(annotations):
    return [np.concatenate([a.data[:, 2:3], a.data[:, :2],
                            a.joint_scales[:, None]], axis=1)
            for a in annotations]


def _decode_both(scenes, cifhr_impl):
    cif = np.stack([s[0] for s in scenes])
    caf = np.stack([s[1] for s in scenes])
    with helpers.jax_f32():
        ref = helpers.jax_cifcaf(STRIDE, cifhr_impl).batch_decode([cif, caf])
    dec = CifCaf(*helpers.port_metas(STRIDE))
    out = dec.batch_decode([_t(cif), _t(caf)])
    return dec, out, ref


@pytest.mark.parametrize('cifhr_impl', ['dense', 'auto'])
@pytest.mark.parametrize('batch', [1, 2])
def test_cifcaf_matches_jax(cifhr_impl, batch):
    """``'auto'`` is JAX's default, the lazy CifHr: the port's map equals it
    up to float summation order."""
    scenes = [helpers.sparse_scene(seed=s) for s in range(batch)]
    dec, out, ref = _decode_both(scenes, cifhr_impl)
    assert dec.last_escalated == []
    assert len(out) == len(ref) == batch
    for ours, theirs in zip(out, ref):
        assert len(theirs) == 3
        helpers.assert_pose_gate(_port_poses(ours), _port_poses(theirs))
        for a, b in zip(ours, theirs):
            assert a.json_data() == b.json_data()


@pytest.mark.parametrize('cifhr_impl', ['dense', 'auto'])
def test_cifcaf_crowd_escalation_matches_jax(cifhr_impl):
    """A crowded image overflows the fast tier's seed budget and is
    re-decoded at the crowd tier; the sparse one beside it is not."""
    dec, out, ref = _decode_both(
        [helpers.sparse_scene(seed=0), helpers.crowd_scene()], cifhr_impl)
    assert dec.last_escalated == [1]
    assert len(ref[1]) >= 8
    for ours, theirs in zip(out, ref):
        helpers.assert_pose_gate(_port_poses(ours), _port_poses(theirs))


def test_unported_config_raises():
    from openpifpaf_tpu_torch.ops.decode_cifcaf import decode_cifcaf
    cif, caf = helpers.sparse_scene(seed=0)
    for field, value in (('cifhr_impl', 'lazy'), ('greedy', True),
                         ('force_complete', True)):
        config = CifCafDecoderConfig(**{field: value})
        with pytest.raises(NotImplementedError, match='ROADMAP'):
            decode_cifcaf(_t(cif[None]), _t(caf[None]), stride=STRIDE,
                          skeleton=SKELETON, config=config)


def test_golden_file_matches_fresh_jax_decode():
    """``tests/golden/torch_decode_golden.npz`` (read by ``chip_smoke.py``
    on the GPU, where JAX is absent) still equals what the JAX package
    decodes from the same scenes; rewrite it with
    ``python tests/torch_port_helpers.py`` when the reference changes."""
    golden = np.load(helpers.GOLDEN)
    fresh = helpers.jax_golden()
    assert sorted(golden.files) == sorted(fresh)
    for name, value in fresh.items():
        np.testing.assert_allclose(golden[name], value, atol=1e-5, rtol=0,
                                   err_msg=name)
    assert len(fresh['sparse_poses']) == 3
    assert len(fresh['crowd_poses']) == 40
    dec = helpers.jax_cifcaf(helpers.GOLDEN_STRIDE)
    *_, overflow = dec._decoder(helpers.GOLDEN_STRIDE)(
        fresh['crowd_cif'][None], fresh['crowd_caf'][None])
    assert bool(np.asarray(overflow)[0])  # the crowd scene escalates
