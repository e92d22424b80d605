"""The decode's loops in the form that ``torch.export`` traces, against
their previous host-loop forms and against the JAX package.

- The fixpoints of ``seed_nms``, ``seed_rank_dedup`` and ``nms_keypoints``
  run as the while-loop operator (:func:`seeds._fixpoint`). Each is held
  bit for bit against the host loop it replaced (iterate until
  ``torch.equal``), and exactly against JAX's ``lax.while_loop`` (indices,
  masks and orders equal; NMS confidences within 1e-6, one product).
- The growth's masked form (every lane grown, the dead ones zeroed, as
  JAX does; the form of an exported program) is held bit for bit against
  the compact form (the live lanes gathered with ``torch.nonzero``; the
  eager form), in each growth mode.

Inputs: seeded random candidates and the golden file's 3- and 40-person
scenes (fields written with the JAX package), taken through the port's
own stages.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from openpifpaf_tpu.ops import nms as jax_nms
from openpifpaf_tpu.ops import seeds as jax_seeds
from openpifpaf_tpu.plugins.coco.constants import COCO_PERSON_SKELETON
from openpifpaf_tpu_torch.ops import caf_scored, cifhr, grow, nms, seeds

import torch_port_helpers as helpers

SKELETON = np.asarray(COCO_PERSON_SKELETON)
CASES = ('random0', 'random1', 'sparse', 'crowd')
GROW_MODES = {'default': {}, 'greedy': {'greedy': True},
              'record_order': {'record_order': True},
              'block_joints': {'block_joints': True},
              'greedy_record': {'greedy': True, 'record_order': True}}


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    helpers.one_torch_thread()


def _host_fixpoint(step, start, *operands):
    """The fixpoint as the port ran it before: a host-side "changed?" test
    (``torch.equal``) after every round."""
    state = start
    while True:
        new = step(state, *operands)
        if torch.equal(new, state):
            return new
        state = new


def _random_case(seed):
    """Random seeds, lanes and poses on a 257x321 map: seeds sorted by
    score with a tail of empty ones, poses whose joints crowd a few
    places so that occupancy windows overlap."""
    rng = np.random.RandomState(seed)
    hr_shape = (257, 321)
    n = 160
    v = np.sort(rng.uniform(0.2, 1.0, n))[::-1].astype(np.float32)
    v[-20:] = 0.0
    centres = rng.uniform(20.0, 240.0, (6, 2))
    pick = rng.randint(0, 6, n)
    seed_dict = {'f': rng.randint(0, 17, n).astype(np.int64), 'v': v,
                 'x': (centres[pick, 0] + rng.randn(n) * 6.0)
                 .astype(np.float32),
                 'y': (centres[pick, 1] + rng.randn(n) * 6.0)
                 .astype(np.float32),
                 's': rng.uniform(1.0, 12.0, n).astype(np.float32)}
    k = 48
    poses = np.zeros((k, 17, 4), np.float32)
    anchor = rng.randint(0, 6, k)
    poses[:, :, 0] = np.where(rng.rand(k, 17) < 0.7,
                              rng.uniform(0.05, 1.0, (k, 17)), 0.0)
    poses[:, :, 1] = centres[anchor, 0, None] + rng.randn(k, 17) * 8.0
    poses[:, :, 2] = centres[anchor, 1, None] + rng.randn(k, 17) * 8.0
    poses[:, :, 3] = rng.uniform(1.0, 10.0, (k, 17))
    lanes = {key: a[:k] for key, a in seed_dict.items()}
    return {'hr_shape': hr_shape, 'seeds': seed_dict, 'lanes': lanes,
            'poses': poses}


def _golden_case(scene):
    """The port's stages on a golden scene at the default budgets: its
    seeds, the lanes that seed NMS grants, their grown poses and the
    candidates they grew from."""
    golden = np.load(helpers.GOLDEN)
    stride = helpers.GOLDEN_STRIDE
    cif = torch.from_numpy(golden[f'{scene}_cif'])
    caf = torch.from_numpy(golden[f'{scene}_caf'])
    hr_shape = ((cif.shape[2] - 1) * stride + 1,
                (cif.shape[3] - 1) * stride + 1)
    hr = cifhr.cif_hr(cif, stride)
    seed_dict = seeds.cif_seeds(cif, hr, stride)
    keep_idx, keep_valid = seeds.seed_nms(seed_dict, 17, hr_shape, n_keep=96)
    lanes = {k: v[keep_idx] for k, v in seed_dict.items()}
    lanes['v'] = torch.where(keep_valid, lanes['v'], 0.0)
    cands = caf_scored.caf_scored(caf, hr, stride, SKELETON,
                                  n_candidates=256)
    graph = grow.make_skeleton_graph(17, SKELETON)
    poses = grow.grow_poses(cands, graph, lanes)
    as_np = {k: v.numpy() for k, v in seed_dict.items()}
    return {'hr_shape': hr_shape, 'seeds': as_np,
            'lanes': {k: v.numpy() for k, v in lanes.items()},
            'poses': poses.numpy(), 'cands': cands}


@pytest.fixture(scope='module')
def cases():
    out = {f'random{s}': _random_case(s) for s in (0, 1)}
    out.update({s: _golden_case(s) for s in ('sparse', 'crowd')})
    assert (out['crowd']['lanes']['v'] > 0).sum() > 30
    return out


def _t(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


def _port_op(op, case):
    """The op's outputs as numpy arrays."""
    if op == 'seed_nms':
        out = seeds.seed_nms(_t(case['seeds']), 17, case['hr_shape'],
                             n_keep=96)
    elif op == 'seed_rank_dedup':
        lanes = _t(case['lanes'])
        out = (seeds.seed_rank_dedup(
            torch.from_numpy(case['poses']), lanes['f'], lanes['x'],
            lanes['y'], lanes['v'] > 0.0, case['hr_shape']),)
    else:
        out = nms.nms_keypoints(torch.from_numpy(case['poses']),
                                case['hr_shape'])
    return [o.numpy() for o in out]


def _jax_op(op, case):
    with helpers.jax_f32():
        if op == 'seed_nms':
            out = jax_seeds.seed_nms(
                {k: jnp.asarray(v) for k, v in case['seeds'].items()}, 17,
                case['hr_shape'], n_keep=96)
        elif op == 'seed_rank_dedup':
            lanes = {k: jnp.asarray(v) for k, v in case['lanes'].items()}
            out = (jax_seeds.seed_rank_dedup(
                jnp.asarray(case['poses']), lanes['f'], lanes['x'],
                lanes['y'], lanes['v'] > 0.0, case['hr_shape']),)
        else:
            out = jax_nms.nms_keypoints(jnp.asarray(case['poses']),
                                        case['hr_shape'])
        return [np.asarray(o) for o in out]


OPS = ('seed_nms', 'seed_rank_dedup', 'nms_keypoints')


@pytest.mark.parametrize('case', CASES)
@pytest.mark.parametrize('op', OPS)
def test_while_loop_fixpoint_equals_host_loop(cases, op, case, monkeypatch):
    ours = _port_op(op, cases[case])
    with monkeypatch.context() as m:
        m.setattr(seeds, '_fixpoint', _host_fixpoint)
        m.setattr(nms, '_fixpoint', _host_fixpoint)
        before = _port_op(op, cases[case])
    for a, b in zip(ours, before):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('case', CASES)
@pytest.mark.parametrize('op', OPS)
def test_while_loop_fixpoint_matches_jax(cases, op, case):
    ours = _port_op(op, cases[case])
    ref = _jax_op(op, cases[case])
    if op == 'nms_keypoints':
        poses, keep, order = ours
        np.testing.assert_array_equal(keep, ref[1])
        np.testing.assert_array_equal(order, ref[2])
        # the suppression is one product, v * 1e-5
        np.testing.assert_allclose(poses, ref[0], atol=1e-6, rtol=0)
        assert keep.any()
        return
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    if op == 'seed_nms':
        # some seed was suppressed: the kept ones are not the first ones
        assert (ours[0] != np.arange(len(ours[0]))).any()
    else:
        assert ours[0].any() and not ours[0].all()


def test_fixpoint_needs_several_rounds(cases):
    """The cases exercise the loop: some fixpoint takes more than two
    rounds (a suppression that a suppressed seed's own window undoes)."""
    rounds = []

    def counted(step, start, *operands):
        state, n = start, 0
        while True:
            new = step(state, *operands)
            n += 1
            if torch.equal(new, state):
                rounds.append(n)
                return new
            state = new

    for case in cases.values():
        with pytest.MonkeyPatch.context() as m:
            m.setattr(seeds, '_fixpoint', counted)
            m.setattr(nms, '_fixpoint', counted)
            for op in OPS:
                _port_op(op, case)
    assert max(rounds) > 2, rounds


def _grow_inputs(cases, case):
    if case.startswith('random'):
        rng = np.random.RandomState(int(case[-1]) + 5)
        n_dir, n_cand = 2 * len(SKELETON), 48
        cands = {k: rng.uniform(28.0, 36.0, (n_dir, n_cand))
                 .astype(np.float32) for k in ('sx', 'sy', 'tx', 'ty')}
        cands['ts'] = rng.uniform(8.0, 14.0, (n_dir, n_cand)).astype(
            np.float32)
        cands['c'] = np.where(rng.rand(n_dir, n_cand) < 0.7,
                              rng.uniform(0.3, 1.0, (n_dir, n_cand)),
                              0.0).astype(np.float32)
        lanes = {'f': rng.randint(0, 17, 24),
                 'v': rng.uniform(0.3, 1.0, 24).astype(np.float32),
                 'x': rng.uniform(28.0, 36.0, 24).astype(np.float32),
                 'y': rng.uniform(28.0, 36.0, 24).astype(np.float32),
                 's': rng.uniform(8.0, 14.0, 24).astype(np.float32)}
        lanes['v'][::3] = 0.0
        return _t(cands), _t(lanes)
    lanes = _t(cases[case]['lanes'])
    # the crowd fills every lane: empty the last ones, as seed NMS does
    lanes['v'] = lanes['v'].clone()
    lanes['v'][-8:] = 0.0
    return cases[case]['cands'], lanes


@pytest.mark.parametrize('mode', sorted(GROW_MODES))
@pytest.mark.parametrize('case', CASES)
def test_masked_grow_equals_compact(cases, case, mode, monkeypatch):
    cands, lanes = _grow_inputs(cases, case)
    graph = grow.make_skeleton_graph(17, SKELETON)
    kw = GROW_MODES[mode]
    monkeypatch.setattr(grow, '_grow_live', grow._grow_masked)
    masked = grow.grow_poses(cands, graph, lanes, **kw)
    monkeypatch.setattr(grow, '_grow_live', grow._grow_compact)
    compact = grow.grow_poses(cands, graph, lanes, **kw)
    compact = compact if isinstance(compact, tuple) else (compact,)
    masked = masked if isinstance(masked, tuple) else (masked,)
    dead = lanes['v'] == 0.0
    assert dead.any() and (~dead).any()
    for a, b in zip(compact, masked):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    assert (compact[0][~dead][:, :, 0] > 0).sum() > (~dead).sum()


def test_grow_is_masked_only_under_export(monkeypatch):
    calls = []
    monkeypatch.setattr(grow, '_grow_compact',
                        lambda *a, **k: calls.append('compact'))
    monkeypatch.setattr(grow, '_grow_masked',
                        lambda *a, **k: calls.append('masked'))
    poses = torch.zeros((2, 17, 4))
    grow._grow_live(None, None, poses, None)
    grow._grow_live(None, None, poses.to('meta'), None)
    monkeypatch.setattr(torch.compiler, 'is_exporting', lambda: True)
    grow._grow_live(None, None, poses, None)
    assert calls == ['compact', 'compact', 'masked']


def test_masked_grow_of_initial_poses(cases, monkeypatch):
    """``grow_from_poses`` (the tracked and force-complete growth): lanes
    without a filled joint but with coordinates give zeros in both forms."""
    cands = cases['sparse']['cands']
    graph = grow.make_skeleton_graph(17, SKELETON)
    poses = torch.from_numpy(cases['sparse']['poses'][:12].copy())
    poses[::2, :, 0] = 0.0
    poses[1::4, 5:, 0] = 0.0
    for kw in ({}, {'record_order': True}):
        with monkeypatch.context() as m:
            m.setattr(grow, '_grow_live', grow._grow_masked)
            masked = grow.grow_from_poses(cands, graph, poses, **kw)
            m.setattr(grow, '_grow_live', grow._grow_compact)
            compact = grow.grow_from_poses(cands, graph, poses, **kw)
        for a, b in zip(*(o if isinstance(o, tuple) else (o,)
                          for o in (compact, masked))):
            assert torch.equal(a, b)
