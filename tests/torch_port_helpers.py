"""Shared pieces of the PyTorch-port parity tests (``test_torch_*.py``).

The JAX package is the reference: each test feeds the same numpy inputs,
made from a seed, to a JAX function and to its port. The JAX side runs
under ``jax.default_matmul_precision('float32')`` because this JAX build's
CPU default matmul precision is bf16-class.

This module also owns ``golden/torch_decode_golden.npz``: decoded fields of
two 513x641 scenes at stride 16 (3 people, with the dense CAF head too, and
40 people, which overflows the fast tier) with the JAX ``CifCaf`` poses
under each decoder configuration of :data:`CONFIGS` (the 40-person
scene under the defaults and force-complete), a fixed set of initial poses
with the poses and ids decoded from them, and the commit arrays of the
decoding-order configurations. ``chip_smoke.py`` and
``test_torch_cuda.py`` decode them with the port on the GPU, where JAX is
not installed, so this module imports JAX only inside the functions that
use it. Run this file to write the golden file anew:

    JAX_PLATFORMS=cpu python tests/torch_port_helpers.py

It also owns ``golden/torch_tracking_golden.npz``: a synthetic 6-frame
video at 513x641, stride 16 (:func:`tracking_scene`), its fields stored
as the cells that differ from an empty cell, with the JAX package's
tracked annotations of each frame. Write it anew with
``--tracking``.
"""

import argparse
import contextlib
import dataclasses
import os

import numpy as np
import torch

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'golden',
                      'torch_decode_golden.npz')
GOLDEN_HW = (513, 641)
GOLDEN_STRIDE = 16


def jax_f32():
    """Context in which JAX matmuls and convolutions run in float32."""
    import jax
    return jax.default_matmul_precision('float32')


def one_torch_thread():
    """Few intra-op threads: the tests run under several xdist workers."""
    torch.set_num_threads(1)


def random_cells(n_fields, n_cells, hr_h, hr_w, seed, device):
    """CifHr cells (x, y, sigma, w) in and around the map, sigmas 1..18,
    40% with weight 0 as the static top-K budget leaves them."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-10.0, hr_w + 10.0, (n_fields, n_cells))
    y = rng.uniform(-10.0, hr_h + 10.0, (n_fields, n_cells))
    sigma = rng.uniform(1.0, 18.0, (n_fields, n_cells))
    w = rng.uniform(0.3, 1.0, (n_fields, n_cells))
    w[rng.rand(n_fields, n_cells) < 0.4] = 0.0
    return [torch.from_numpy(a.astype(np.float32)).to(device)
            for a in (x, y, sigma, w)]


def golden_cells(device):
    """The decode's real CifHr cells: ``select_cells`` on the golden file's
    sparse and crowd CIF fields at the fast tier's and the crowd tier's
    budgets, with the decoder's threshold. Returns {'sparse K=256': (x, y,
    sigma, w), ...} for the (GOLDEN_HW) map of stride GOLDEN_STRIDE."""
    from openpifpaf_tpu_torch.ops.cifhr import select_cells
    from openpifpaf_tpu_torch.ops.decode_cifcaf import CifCafDecoderConfig

    golden = np.load(GOLDEN)
    config = CifCafDecoderConfig()
    out = {}
    for name in ('sparse', 'crowd'):
        cif = torch.from_numpy(golden[f'{name}_cif']).to(device)
        for n_cells in (config.n_hr_cells, config.crowd().n_hr_cells):
            *cells, _ = select_cells(cif, GOLDEN_STRIDE,
                                     threshold=config.cifhr_threshold,
                                     min_scale=config.cifhr_min_scale,
                                     n_cells=n_cells)
            out[f'{name} K={n_cells}'] = cells
    return out


def cifhr_cases(shapes, hr_h, hr_w, device):
    """{label: (x, y, sigma, w)} of the CifHr kernel's timed cases: seeded
    :func:`random_cells` for each (F, K) of ``shapes`` on the (hr_h, hr_w)
    map, then :func:`golden_cells` (whose map is GOLDEN_HW at
    GOLDEN_STRIDE)."""
    cases = {f'F={f} K={k}': random_cells(f, k, hr_h, hr_w, seed=f + k,
                                          device=device)
             for f, k in shapes}
    cases.update({f'golden {name}': cells
                  for name, cells in golden_cells(device).items()})
    return cases


def backbone_kernel_inputs(kernel, shape, *, k=5, dilation=1, act=False,
                           leaky=False, dtype=torch.float32, device='cpu',
                           seed=0):
    """Seeded ``(args, kwargs)`` of a backbone kernel's wrapper:
    ``'depthwise_conv'`` on a channels_last (N, C, H, W) activation, or a
    block kernel (``'shuffle_block'``, ``'shuffle_branch2'``) on
    (N, 2Cb, H, W), with 1x1 weights scaled by 1/sqrt(Cb) so that the
    outputs stay of order one."""
    from openpifpaf_tpu_torch.models.shuffle_cuda import BlockWeights

    g = torch.Generator().manual_seed(seed)

    def rand(*size, scale=1.0):
        return (scale * torch.randn(*size, generator=g)).to(device, dtype)

    c = shape[1]
    x = rand(*shape).contiguous(memory_format=torch.channels_last)
    if kernel == 'depthwise_conv':
        return ((x, rand(c, 1, k, k, scale=0.2), rand(c, scale=0.1)),
                dict(dilation=dilation, act=act, leaky=leaky))
    cb = c // 2
    weights = BlockWeights(
        w1=rand(cb, cb, scale=cb ** -0.5), b1=rand(cb, scale=0.1),
        wdw=rand(cb, 1, k, k, scale=0.2), bdw=rand(cb, scale=0.1),
        w3=rand(cb, cb, scale=cb ** -0.5), b3=rand(cb, scale=0.1))
    return (x, weights), dict(k=k, dilation=dilation, leaky=leaky)


def lab_arrays(kernel, h, w, c, *, k=5, seed=0):
    """Seeded float32 numpy inputs of a Mosaic lab kernel whose output is
    (h, w, c), by the lab's names (``tools/mosaic_lab.py``):
    ``'lab_interleave'`` a, b; ``'lab_dw_valid'`` x (haloed), wt;
    ``'lab_branch2'`` x2 with real data in its halo, 1x1 matrices scaled
    by 1/sqrt(C) so that the outputs stay of order one, biases of both
    signs."""
    rng = np.random.RandomState(seed)
    pad = k // 2

    def randn(*shape, scale=1.0):
        return (scale * rng.randn(*shape)).astype(np.float32)

    if kernel == 'lab_interleave':
        return dict(a=randn(h, w, c), b=randn(h, w, c))
    x = randn(h + 2 * pad, w + 2 * pad, c)
    if kernel == 'lab_dw_valid':
        return dict(x=x, wt=randn(k, k, c, scale=0.2))
    return dict(x2=x, w1=randn(c, c, scale=c ** -0.5), b1=randn(c, scale=0.3),
                wd=randn(k, k, c, scale=0.2), bd=randn(c, scale=0.1),
                w3=randn(c, c, scale=c ** -0.5), b3=randn(c, scale=0.3))


def lab_kernel_inputs(kernel, h, w, c, *, k=5, dtype=torch.float32,
                      device='cpu', seed=0, batch=1):
    """The positional arguments of a lab kernel's wrapper
    (:mod:`openpifpaf_tpu_torch.lab.kernels`) on :func:`lab_arrays`; with
    ``batch`` > 1, image i's activations are those of seed ``seed + i``."""
    from openpifpaf_tpu_torch.lab.kernels import LAB_LAYOUTS, \
        Branch2Weights, from_lab_arrays

    images = [from_lab_arrays(dtype, device,
                              **lab_arrays(kernel, h, w, c, k=k, seed=seed + i))
              for i in range(batch)]
    t = images[0]
    for name in t:
        if LAB_LAYOUTS[name] == 'hwc':
            t[name] = torch.cat([im[name] for im in images]).contiguous(
                memory_format=torch.channels_last)
    if kernel == 'lab_branch2':
        x2 = t.pop('x2')
        return x2, Branch2Weights(**t)
    return tuple(t.values())


def jitter(cif, caf, seed):
    """Break the bit-equal confidence ties of raw encoder targets with a
    1% per-cell jitter (the tie-free regime of
    ``test_adversarial_parity.py``)."""
    rng = np.random.RandomState(1000 + seed)
    cif = cif.copy()
    caf = caf.copy()
    cif[:, 1] *= (1.0 + rng.uniform(-0.01, 0.01, cif[:, 1].shape)
                  ).astype(np.float32)
    caf[:, 1] *= (1.0 + rng.uniform(-0.01, 0.01, caf[:, 1].shape)
                  ).astype(np.float32)
    return cif, caf


def row_scene(n_people, hw, stride, *, height, seed, spacing=(80.0, 90.0),
              origin=(60.0, 90.0), with_dense=False):
    """Decoded CIF/CAF fields of ``n_people`` upright people on a grid,
    jittered to be tie-free; with ``with_dense`` also the field of the
    dense CAF head (``DENSER_COCO_PERSON_CONNECTIONS``), jittered alike."""
    import field_fixtures  # imports the JAX package

    rng = np.random.RandomState(seed)
    cols = max(1, int((hw[1] - origin[0]) // spacing[0]))
    anns = []
    for i in range(n_people):
        cx = origin[0] + (i % cols) * spacing[0] + rng.uniform(-5.0, 5.0)
        cy = origin[1] + (i // cols) * spacing[1] + rng.uniform(-5.0, 5.0)
        anns.append(field_fixtures.annotation_dict(
            field_fixtures.synthetic_person(cx, cy, height, rng)))
    cif, caf, _ = field_fixtures.fields_from_annotations(anns, hw,
                                                         stride=stride)
    cif, caf = jitter(cif, caf, seed)
    if not with_dense:
        return cif, caf
    cif_meta, _, dcaf_meta = jax_metas(stride, with_dense=True)
    _, dcaf, _ = field_fixtures.fields_from_annotations(
        anns, hw, stride=stride, metas=(cif_meta, dcaf_meta))
    _, dcaf = jitter(cif[:1], dcaf, seed + 500)
    return cif, caf, dcaf


def sparse_scene(seed=0):
    """3 people, stride 8: decodes at the fast tier."""
    return row_scene(3, (169, 257), 8, height=90.0, seed=seed)


def crowd_scene(seed=7):
    """12 people, stride 8: overflows the fast tier's seed budget, so the
    decoder escalates to the crowd tier."""
    return row_scene(12, (169, 257), 8, height=45.0, seed=seed,
                     spacing=(45.0, 60.0), origin=(30.0, 40.0))


def golden_scenes():
    """The two scenes of the golden file, fields at stride 16: (cif, caf,
    dense caf) of 3 people and (cif, caf) of 40."""
    sparse = row_scene(3, GOLDEN_HW, GOLDEN_STRIDE, height=110.0, seed=11,
                       spacing=(170.0, 90.0), origin=(90.0, 140.0),
                       with_dense=True)
    crowd = row_scene(40, GOLDEN_HW, GOLDEN_STRIDE, height=65.0, seed=13,
                      spacing=(75.0, 90.0), origin=(35.0, 60.0))
    return {'sparse': sparse, 'crowd': crowd}


#: decoder configurations held against JAX: name -> (CLI flags of the
#: decoders, config fields that no flag sets). ``'dense_connections'`` is
#: ``CifCafDense`` on three heads; ``'tracked'`` decodes with initial poses
#: (:func:`initial_annotations`) under the defaults.
CONFIGS = {
    'default': ((), {}),
    'lazy': ((), {'cifhr_impl': 'lazy'}),
    'greedy': (('--greedy',), {}),
    'block_joints': (('--cifcaf-block-joints',), {}),
    'force_complete': (('--force-complete-pose',), {}),
    'force_complete_nms': (('--force-complete-pose',
                            '--nms-before-force-complete'), {}),
    'decoding_order': ((), {'export_decoding_order': True}),
    'decoding_order_greedy_fc': (('--greedy', '--force-complete-pose'),
                                 {'export_decoding_order': True}),
    'tracked': ((), {}),
    'cifseeds_nms': (('--ablation-cifseeds-nms',), {}),
    'cifseeds_no_rescore': (('--ablation-cifseeds-no-rescore',), {}),
    'caf_no_rescore': (('--ablation-caf-no-rescore',), {}),
    'no_rescore': (('--ablation-cifseeds-no-rescore',
                    '--ablation-caf-no-rescore'), {}),
    'independent_kp': (('--force-complete-pose',
                        '--ablation-independent-kp'), {}),
    'dense_connections': (('--dense-connections',), {}),
}
#: the golden file's configurations: the sparse scene under each of
#: CONFIGS except 'lazy', which is JAX's default; the crowd scene under
#: these
GOLDEN_CROWD_CONFIGS = ('force_complete',)
#: the sparse scene's weakened runs take a seed budget that holds every
#: seed candidate: at the default budget the candidates of the joints that
#: no pose reaches overflow it, and the decode escalates
GOLDEN_SPARSE_FLAGS = ('--decoder-seeds', '1024')
#: CAF edges (0-based, of COCO_PERSON_SKELETON) that :func:`weaken` damps:
#: left ankle-knee and left elbow-wrist, the only edges to the left ankle
#: and wrist
WEAK_EDGES = (0, 10)


def weaken(caf, factor=0.25):
    """A copy of (..., E, 8, H, W) CAF fields with the confidences of
    WEAK_EDGES scaled by ``factor``, below the CAF threshold: the default
    decode then misses the joints they lead to, which force-complete,
    block_joints and the dense connections act on."""
    caf = np.array(caf, copy=True)
    caf[..., WEAK_EDGES, 1, :, :] *= np.float32(factor)
    return caf
#: initial poses of the 'tracked' configuration: slots and ids
TRACKED_IDS = (5, 9)


@contextlib.contextmanager
def restored_statics(*classes):
    """Put back every public class attribute of ``classes`` on exit (the
    decoders' ``configure`` sets class statics)."""
    saved = [(c, dict(vars(c))) for c in classes]
    try:
        yield
    finally:
        for c, attrs in saved:
            for k in set(vars(c)) - set(attrs):
                delattr(c, k)
            for k, v in attrs.items():
                if not k.startswith('__') and vars(c).get(k) is not v:
                    setattr(c, k, v)


def _with_config(dec, overrides):
    inner = getattr(dec, 'cifcaf', dec)  # CifCafDense wraps a CifCaf
    inner.config = dataclasses.replace(inner.config, **overrides)
    return dec


def jax_decoder(stride, flags=(), overrides=None):
    """The JAX package's decoder that ``flags`` select, with ``overrides``
    of its config (three head metas under ``--dense-connections``)."""
    from openpifpaf_tpu import decoder
    parser = argparse.ArgumentParser()
    with restored_statics(*decoder.factory.DECODERS):
        decoder.factory.cli(parser)
        decoder.factory.configure(parser.parse_args(list(flags)))
        metas = jax_metas(stride, with_dense='--dense-connections' in flags)
        decs = decoder.factory.decoders(metas, ['cifcafdense', 'cifcaf'])
    assert len(decs) == 1, decs
    return _with_config(decs[0], overrides or {})


def port_decoder(stride, flags=(), overrides=None):
    """The port's decoder that ``flags`` select (the same CLI as the JAX
    package's), with ``overrides`` of its config."""
    from openpifpaf_tpu_torch import decoder
    parser = argparse.ArgumentParser()
    with restored_statics(*decoder.DECODERS):
        decoder.cli(parser)
        decoder.configure(parser.parse_args(list(flags)))
        metas = port_metas(stride,
                           with_dense='--dense-connections' in flags)
        decs = decoder.decoders(metas, ['cifcafdense', 'cifcaf'])
    assert len(decs) == 1, decs
    return _with_config(decs[0], overrides or {})


def jax_metas(stride, with_dense=False):
    from openpifpaf_tpu.plugins.coco.cocokp import CocoKp
    with restored_statics(CocoKp):
        CocoKp.with_dense = with_dense
        metas = CocoKp().head_metas
    for i, m in enumerate(metas):
        m.head_index = i
        m.base_stride = stride
    return metas


def port_metas(stride, with_dense=False):
    from openpifpaf_tpu_torch.models.shell import assign_strides
    from openpifpaf_tpu_torch.plugins.coco.constants import cocokp_head_metas
    return assign_strides(cocokp_head_metas(with_dense), stride)


def jax_cifcaf(stride, cifhr_impl='auto'):
    """The JAX package's CifCaf decoder with the given CifHr impl."""
    return jax_decoder(stride, overrides={'cifhr_impl': cifhr_impl})


def annotations_from_rows(rows, ids=()):
    """Port COCO annotations of (n, n_kp, 4) [v, x, y, s] rows, the first
    ``len(ids)`` with those ids."""
    from openpifpaf_tpu_torch.annotation import Annotation
    from openpifpaf_tpu_torch.plugins.coco import constants
    anns = []
    for i, row in enumerate(rows):
        ann = Annotation(constants.COCO_KEYPOINTS,
                         constants.COCO_PERSON_SKELETON,
                         score_weights=constants.COCO_PERSON_SCORE_WEIGHTS)
        ann.data[:, 0] = row[:, 1]
        ann.data[:, 1] = row[:, 2]
        ann.data[:, 2] = row[:, 0]
        ann.joint_scales = np.array(row[:, 3], np.float32)
        if i < len(ids):
            ann.id_ = ids[i]
        anns.append(ann)
    return anns


def initial_annotations(poses, ids=TRACKED_IDS):
    """Port annotations of the first ``len(ids)`` of (K, n_kp, 4) poses,
    with the upper body only (joints 0-10), shifted by (1.5, -1.0) px and
    the given ids: the tracked poses of a previous frame."""
    rows = np.zeros((len(ids),) + poses.shape[1:], np.float32)
    rows[:, :11] = poses[:len(ids), :11]
    rows[:, :11, 1] += 1.5
    rows[:, :11, 2] -= 1.0
    return annotations_from_rows(rows, ids)


def golden_runs():
    """Every decode of the golden scenes that the card holds against the
    golden file: (label, scene, configuration, CLI flags, config
    overrides, golden key, whether the CifHr kernel launches). First the
    default configuration under each CifHr impl on the 3-person scene
    ('auto' and 'pallas' launch the kernel; 'lazy' and 'dense' do not) and
    the map and the lazy one on the 40-person scene; then each
    configuration of CONFIGS on the weakened scenes ('no_rescore', which
    skips CifHr, launches nothing)."""
    runs = [(f'cifhr {impl}', 'sparse', 'default', (), {'cifhr_impl': impl},
             'sparse', impl in ('auto', 'pallas'))
            for impl in ('auto', 'pallas', 'lazy', 'dense')]
    runs += [(f'crowd cifhr {impl}', 'crowd', 'default', (),
              {'cifhr_impl': impl}, 'crowd', impl == 'auto')
             for impl in ('auto', 'lazy')]
    # JAX's default CifHr is the lazy one: 'lazy' holds to the defaults
    runs += [(name, 'sparse', name, CONFIGS[name][0] + GOLDEN_SPARSE_FLAGS,
              CONFIGS[name][1],
              'sparse_default' if name == 'lazy' else f'sparse_{name}',
              name not in ('lazy', 'no_rescore'))
             for name in CONFIGS]
    runs += [(f'crowd {name}', 'crowd', name, CONFIGS[name][0],
              CONFIGS[name][1], f'crowd_{name}', True)
             for name in GOLDEN_CROWD_CONFIGS]
    return runs


def golden_inputs(golden, scene, config, key, device):
    """(batch-1 head fields on ``device``, initial annotations or None) of
    a run of :func:`golden_runs`: the weakened CAF for every key but the
    scenes' own defaults, the dense head for 'dense_connections'."""
    caf = golden[f'{scene}_caf']
    if key != scene:
        caf = weaken(caf)
    fields = [golden[f'{scene}_cif'], caf]
    if config == 'dense_connections':
        fields.append(golden[f'{scene}_dcaf'])
    fields = [torch.from_numpy(np.ascontiguousarray(f[None])).to(device)
              for f in fields]
    initial = None
    if config == 'tracked':
        initial = [annotations_from_rows(golden[f'{key}_init'],
                                         TRACKED_IDS)]
    return fields, initial


def pose_rows(annotations):
    """(n, n_kp, 4) [v, x, y, s] of annotations, in their order."""
    return np.asarray([np.concatenate([a.data[:, 2:3], a.data[:, :2],
                                       a.joint_scales[:, None]], axis=1)
                       for a in annotations], np.float32).reshape(
        len(annotations), -1, 4)


def order_rows(annotations):
    """(n, n_kp, 3) int of each annotation's ``decoding_order`` and
    ``frontier_order``: for each joint its position in the decoding order
    and its source joint (-1, -1 where none committed it), and the bit
    mask of the source joints of the frontier edges that end at it (the
    frontier is listed in the skeleton's order, so the masks give the
    list)."""
    out = []
    for a in annotations:
        rows = np.full((a.data.shape[0], 3), -1, np.int64)
        rows[:, 2] = 0
        for i, (jsi, jti, _, _) in enumerate(a.decoding_order):
            rows[jti, :2] = (i, jsi)
        for s, t in a.frontier_order:
            rows[t, 2] |= 1 << s
        out.append(rows)
    return np.asarray(out, np.int64).reshape(len(annotations), -1, 3)


def assert_pose_gate(ours, ref, *, xy_atol=1e-3, conf_atol=2e-3):
    """The tie-free gate of ``test_adversarial_parity.py``: the same number
    of poses; each of ours, matched to the nearest unused reference pose,
    has the same visibility, locations within ``xy_atol`` px and
    confidences within ``conf_atol``."""
    assert len(ours) == len(ref), (len(ours), len(ref))
    used = set()
    for op in ours:
        vis_o = op[:, 0] > 0
        best, best_d = None, None
        for i, rp in enumerate(ref):
            if i in used:
                continue
            vis = vis_o & (rp[:, 0] > 0)
            if not np.any(vis):
                continue
            d = float(np.linalg.norm(rp[vis, 1:3] - op[vis, 1:3],
                                     axis=1).mean())
            if best_d is None or d < best_d:
                best, best_d = i, d
        assert best is not None, 'pose matches no reference pose'
        used.add(best)
        rp = ref[best]
        np.testing.assert_array_equal(vis_o, rp[:, 0] > 0)
        np.testing.assert_allclose(op[vis_o, 1:3], rp[vis_o, 1:3],
                                   atol=xy_atol)
        np.testing.assert_allclose(op[vis_o, 0], rp[vis_o, 0],
                                   atol=conf_atol)


def golden_configs():
    """The (scene, configuration) pairs of the golden file's configuration
    entries: the 3-person scene under each of CONFIGS but 'lazy' (JAX's
    default), the 40-person scene under GOLDEN_CROWD_CONFIGS."""
    return ([('sparse', c) for c in CONFIGS if c != 'lazy']
            + [('crowd', c) for c in GOLDEN_CROWD_CONFIGS])


def golden_config_keys(scene, config):
    """The names that an entry of :func:`jax_golden_config` may have."""
    return {f'{scene}_{config}_{suffix}'
            for suffix in ('poses', 'order', 'init', 'ids')}


def jax_golden_scenes(scenes):
    """The golden file's fields of ``scenes`` (:func:`golden_scenes`):
    ``{scene}_cif``/``_caf`` (and ``sparse_dcaf``), with ``{scene}_poses``,
    the JAX decode under the defaults (kept poses in score order)."""
    out = {}
    with jax_f32():
        for name, fields in scenes.items():
            for head, f in zip(('cif', 'caf', 'dcaf'), fields):
                out[f'{name}_{head}'] = f
            anns = jax_decoder(GOLDEN_STRIDE).batch_decode(
                [f[None] for f in fields[:2]])[0]
            out[f'{name}_poses'] = pose_rows(anns)
    return out


def jax_golden_config(scenes, scene, config, default_poses=None):
    """The golden file's entries of one (scene, configuration) pair, on
    the fields with :func:`weaken`'s CAF: ``{scene}_{config}_poses``,
    ``_order`` of a decoding-order configuration (:func:`order_rows`), and
    for 'tracked' the initial poses (``_init``, made from
    ``default_poses``, the damped scene's default poses) and the ids
    decoded (``_ids``)."""
    cif, caf, *dcaf = scenes[scene]
    fields = [f[None] for f in [cif, weaken(caf)] + dcaf]
    flags, overrides = CONFIGS[config]
    if scene == 'sparse':
        flags += GOLDEN_SPARSE_FLAGS
    key = f'{scene}_{config}'
    out = {}
    initial = None
    if config == 'tracked':
        init = initial_annotations(default_poses)
        out[f'{key}_init'] = pose_rows(init)
        initial = [init]
    with jax_f32():
        anns = jax_decoder(GOLDEN_STRIDE, flags, overrides).batch_decode(
            fields if config == 'dense_connections' else fields[:2],
            initial)[0]
    out[f'{key}_poses'] = pose_rows(anns)
    if overrides.get('export_decoding_order'):
        out[f'{key}_order'] = order_rows(anns)
    if config == 'tracked':
        out[f'{key}_ids'] = np.asarray(
            [-1 if a.id_ is None else a.id_ for a in anns])
    return out


#: a narrow ShuffleNetV2K (stages_repeats, stages_out_channels) for the
#: parity tests
NARROW = ([1, 2, 1], [8, 16, 32, 64, 64])


def randomize_variables(variables, seed):
    """Flax variables with BatchNorm scale/var in [0.5, 1.5] and biases
    and means ~ N(0, 0.1), so that no layer is an identity."""
    import jax
    rng = np.random.RandomState(seed)

    def leaf(path, a):
        a = np.asarray(a)
        name = path[-1].key
        if name in ('scale', 'var'):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name in ('bias', 'mean'):
            return (0.1 * rng.randn(*a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(leaf, variables)


def jax_narrow_shell(metas, *, dropout_p=0.0):
    """The JAX package's Shell of a :data:`NARROW` ShuffleNetV2K and a
    CompositeField4 per meta."""
    from openpifpaf_tpu.models import basenetworks
    from openpifpaf_tpu.models.heads import CompositeField4
    from openpifpaf_tpu.models.shell import Shell, assign_strides
    base = basenetworks.ShuffleNetV2K(stages_repeats=NARROW[0],
                                      stages_out_channels=NARROW[1])
    assign_strides(metas, base.stride)
    return Shell(base_net=base, head_nets=tuple(
        CompositeField4(meta=m, dropout_p=dropout_p) for m in metas))


def jax_narrow_tracking_shell(metas):
    """The JAX package's TrackingShell of a :data:`NARROW` ShuffleNetV2K
    with a TBaseSingleImage per single-image meta and a Tcaf head."""
    from openpifpaf_tpu import headmeta
    from openpifpaf_tpu.models import basenetworks, tracking
    from openpifpaf_tpu.models.shell import assign_strides
    base = basenetworks.ShuffleNetV2K(stages_repeats=NARROW[0],
                                      stages_out_channels=NARROW[1])
    assign_strides(metas, base.stride)
    return tracking.TrackingShell(base_net=base, head_nets=tuple(
        tracking.Tcaf(meta=m) if isinstance(m, headmeta.Tcaf)
        else tracking.TBaseSingleImage(meta=m) for m in metas))


def port_narrow_shell(metas):
    from openpifpaf_tpu_torch.models import basenetworks
    from openpifpaf_tpu_torch.models.factory import Factory
    return Factory().from_scratch(
        metas, base_net=basenetworks.ShuffleNetV2K(*NARROW))


def optimizer_args(**overrides):
    """The optimizer and schedule flags' defaults with ``overrides``."""
    import argparse
    from openpifpaf_tpu_torch.training import optimize
    parser = argparse.ArgumentParser()
    optimize.cli(parser)
    args = parser.parse_args([])
    for k, v in overrides.items():
        if not hasattr(args, k):
            raise KeyError(k)
        setattr(args, k, v)
    return args


def write_synthetic_coco(directory, *, n_images=16, image_hw=(113, 129),
                         seed=0):
    """A COCO keypoint set made from ``np.random.RandomState(seed)``: JPEG
    images of ``image_hw`` with 1-4 upright people each (their visible
    joints painted as 5x5 squares of a colour per joint on dark noise)
    and the annotation JSON. Returns (annotation file, image directory).
    Visibility is 2 for 80% of the joints, 1 for 10%, 0 for the rest and
    for joints outside the image."""
    import json
    import PIL.Image
    from openpifpaf_tpu_torch.plugins.coco.constants import \
        COCO_KEYPOINTS, COCO_PERSON_SKELETON, COCO_UPRIGHT_POSE

    rng = np.random.RandomState(seed)
    image_dir = os.path.join(directory, 'images')
    os.makedirs(image_dir, exist_ok=True)
    h, w = image_hw
    colors = rng.randint(96, 256, (len(COCO_KEYPOINTS), 3))
    pose = COCO_UPRIGHT_POSE[:, :2]
    images, annotations = [], []
    for image_id in range(1, n_images + 1):
        image = rng.randint(0, 64, (h, w, 3)).astype(np.uint8)
        for _ in range(rng.randint(1, 5)):
            scale = rng.uniform(0.4, 0.9) * h / np.ptp(pose[:, 1])
            x = rng.uniform(0.1, 0.9) * w + scale * pose[:, 0]
            y = rng.uniform(0.5, 1.0) * h - scale * (pose[:, 1]
                                                     - pose[:, 1].min())
            v = rng.choice([2.0, 1.0, 0.0], size=len(pose),
                           p=[0.8, 0.1, 0.1])
            inside = (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)
            v[~inside] = 0.0
            if np.sum(v > 0) < 3:
                continue
            keypoints = np.stack([np.where(v > 0, x, 0.0),
                                  np.where(v > 0, y, 0.0), v], axis=1)
            for (kx, ky, kv), color in zip(keypoints, colors):
                if kv > 0:
                    image[max(0, int(ky) - 2):int(ky) + 3,
                          max(0, int(kx) - 2):int(kx) + 3] = color
            vx, vy = x[v > 0], y[v > 0]
            bbox = [float(vx.min()) - 4.0, float(vy.min()) - 4.0,
                    float(np.ptp(vx)) + 8.0, float(np.ptp(vy)) + 8.0]
            annotations.append({
                'id': len(annotations) + 1, 'image_id': image_id,
                'category_id': 1, 'iscrowd': 0,
                'keypoints': [round(float(c), 2)
                              for c in keypoints.reshape(-1)],
                'num_keypoints': int(np.sum(v > 0)),
                'bbox': [round(c, 2) for c in bbox],
                'area': round(bbox[2] * bbox[3], 2),
            })
        file_name = f'{image_id:012d}.jpg'
        PIL.Image.fromarray(image).save(os.path.join(image_dir, file_name),
                                        quality=95)
        images.append({'id': image_id, 'file_name': file_name,
                       'width': w, 'height': h})
    ann_file = os.path.join(directory, 'person_keypoints.json')
    with open(ann_file, 'w') as f:
        json.dump({'images': images, 'annotations': annotations,
                   'categories': [{'id': 1, 'name': 'person',
                                   'keypoints': COCO_KEYPOINTS,
                                   'skeleton': COCO_PERSON_SKELETON}]}, f)
    return ann_file, image_dir


def write_synthetic_posetrack2018(directory, *, n_sequences=2, n_frames=4,
                                  image_hw=(720, 1280), n_people=3, seed=0):
    """A PoseTrack 2018 set made from ``np.random.RandomState(seed)``, in
    the layout that ``plugins/posetrack/datasets.py`` reads: per sequence
    one JSON (``images`` with ``frame_id``, ``file_name`` and the ignore
    regions, ``annotations`` with ``image_id``, ``track_id``, ``bbox``,
    ``bbox_head`` and 17 keypoints) written to ``annotations/train`` and
    ``annotations/val``, and its frames as JPEGs of ``image_hw`` under
    ``images/val/<sequence>/``. Each sequence has ``n_people`` upright
    people with track ids 0.. who move a few pixels per frame (their
    annotated joints painted as 7x7 squares of a colour per joint on dark
    noise) and one rectangular ignore region. As in PoseTrack, annotated
    joints have v=1 and the ears are never annotated. Returns (train
    annotation glob, val annotation glob, data root)."""
    import json
    import PIL.Image
    from openpifpaf_tpu_torch.plugins.posetrack.constants import \
        UPRIGHT_POSE

    rng = np.random.RandomState(seed)
    h, w = image_hw
    colors = rng.randint(96, 256, (len(UPRIGHT_POSE), 3))
    pose = UPRIGHT_POSE[:, :2]
    for split in ('train', 'val'):
        os.makedirs(os.path.join(directory, 'annotations', split),
                    exist_ok=True)
    for s in range(n_sequences):
        name = f'{s + 1:06d}_mpii_test'
        image_dir = os.path.join('images', 'val', name)
        os.makedirs(os.path.join(directory, image_dir), exist_ok=True)
        people = [(rng.uniform(0.15, 0.85) * w, rng.uniform(0.6, 0.95) * h,
                   rng.uniform(0.35, 0.7) * h / np.ptp(pose[:, 1]),
                   rng.uniform(-6.0, 6.0, 2)) for _ in range(n_people)]
        x0, y0 = rng.uniform(0.0, 0.8) * w, rng.uniform(0.0, 0.8) * h
        region_x = [x0, x0 + 0.1 * w, x0 + 0.1 * w, x0]
        region_y = [y0, y0, y0 + 0.1 * h, y0 + 0.1 * h]
        images, annotations = [], []
        for t in range(n_frames):
            frame_id = 10000 * (s + 1) + t
            image = rng.randint(0, 64, (h, w, 3)).astype(np.uint8)
            for track_id, (cx, cy, scale, velocity) in enumerate(people):
                x = cx + velocity[0] * t + scale * pose[:, 0]
                y = cy + velocity[1] * t - scale * (pose[:, 1]
                                                    - pose[:, 1].min())
                v = np.ones(len(pose))
                v[3:5] = 0.0
                v[(x < 0) | (x > w - 1) | (y < 0) | (y > h - 1)] = 0.0
                keypoints = np.stack([np.where(v > 0, x, 0.0),
                                      np.where(v > 0, y, 0.0), v], axis=1)
                for (kx, ky, kv), color in zip(keypoints, colors):
                    if kv > 0:
                        image[max(0, int(ky) - 3):int(ky) + 4,
                              max(0, int(kx) - 3):int(kx) + 4] = color
                vx, vy = x[v > 0], y[v > 0]
                bbox = [float(vx.min()) - 6.0, float(vy.min()) - 6.0,
                        float(np.ptp(vx)) + 12.0, float(np.ptp(vy)) + 12.0]
                head = [float(x[2]) - 10.0, float(y[2]) - 4.0, 20.0,
                        float(y[1] - y[2]) + 8.0]
                annotations.append({
                    'id': len(annotations) + 1, 'image_id': frame_id,
                    'track_id': track_id, 'category_id': 1,
                    'keypoints': [round(float(c), 2)
                                  for c in keypoints.reshape(-1)],
                    'bbox': [round(c, 2) for c in bbox],
                    'bbox_head': [round(c, 2) for c in head],
                })
            file_name = os.path.join(image_dir, f'{t:06d}.jpg')
            PIL.Image.fromarray(image).save(
                os.path.join(directory, file_name), quality=95)
            images.append({
                'id': frame_id, 'frame_id': frame_id, 'vid_id': name,
                'file_name': file_name, 'nframes': n_frames,
                'is_labeled': True,
                'ignore_regions_x': [[round(c, 2) for c in region_x]],
                'ignore_regions_y': [[round(c, 2) for c in region_y]],
            })
        for split in ('train', 'val'):
            with open(os.path.join(directory, 'annotations', split,
                                   f'{name}.json'), 'w') as f:
                json.dump({'images': images, 'annotations': annotations,
                           'categories': [{'id': 1, 'name': 'person'}]}, f)
    return (os.path.join(directory, 'annotations', 'train', '*.json'),
            os.path.join(directory, 'annotations', 'val', '*.json'),
            directory)


#: the committed orbax checkpoint of the JAX package: a resnet18 without
#: its last block, overfit on one image (``tests/test_fixture_checkpoint.py``)
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       'fixtures', 'overfit_fixture')


def orbax_to_port_checkpoint(src, dst):
    """The JAX package's checkpoint ``src`` (``src.json`` and the orbax
    directory ``src.arrays``) as a checkpoint of the port at ``dst``
    (``dst.json`` with the same meta, ``dst.pt`` from
    ``convert_jax.state_dict_from_jax``); returns ``dst``. It needs the JAX
    package and orbax, so it runs where the tests run, not on the card's
    machine."""
    from openpifpaf_tpu.training import checkpoint as jax_checkpoint
    from openpifpaf_tpu_torch.models import convert_jax
    from openpifpaf_tpu_torch.training import checkpoint as port_checkpoint

    arrays, meta = jax_checkpoint.load(src)
    state_dict = convert_jax.state_dict_from_jax(
        {'params': arrays['params'], 'batch_stats': arrays['batch_stats']})
    port_checkpoint.save(dst, state_dict=state_dict, meta=meta)
    return dst


def numpy_variables(shapes, seed):
    """Flax variables of the ``jax.eval_shape`` tree ``shapes`` drawn with
    numpy (no flax init to compile): kernels ~ N(0, 1 / fan-in), the rest
    as :func:`randomize_variables` draws them."""
    import jax
    rng = np.random.RandomState(seed)

    def leaf(path, a):
        name = path[-1].key
        if name == 'kernel':
            fan_in = int(np.prod(a.shape[:-1]))
            return (rng.randn(*a.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name in ('scale', 'var'):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (0.1 * rng.randn(*a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_tracking_checkpoints(directory, metas, *, bias=-3.0):
    """A resnet18 tracking model of the JAX package with ``metas`` (head
    index and stride set), random weights (:func:`numpy_variables` seed
    8) and ``bias`` (one value, or one per head) added to the heads'
    confidence biases (so that the decode of its fields keeps poses),
    saved as a JAX checkpoint and converted with
    :func:`orbax_to_port_checkpoint`. Returns (the JAX checkpoint, the
    port's)."""
    import jax
    from openpifpaf_tpu.models import factory as jax_factory
    from openpifpaf_tpu.training import checkpoint as jax_checkpoint

    model, _ = jax_factory.Factory(base_name='resnet18').from_scratch(metas)
    variables = numpy_variables(jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0),
                           jax.numpy.zeros((2, 97, 129, 3)), train=True)),
        seed=8)
    params = variables['params']
    biases = np.broadcast_to(bias, (len(metas),))
    for i, meta in enumerate(metas):
        conv = params[f'head_nets_{i}']['CompositeField4_0']['Conv_0']
        b = conv['bias'].reshape(meta.n_fields, meta.n_components).copy()
        b[:, 1] += biases[i]
        conv['bias'] = b.reshape(-1)
    src = os.path.join(directory, 'jax')
    jax_checkpoint.save_shell(src, base_name='resnet18', head_metas=metas,
                              params=params,
                              batch_stats=variables['batch_stats'])
    return src, orbax_to_port_checkpoint(src, os.path.join(directory,
                                                           'port'))


#: the tracking golden file: a synthetic video with the JAX package's
#: tracked poses and ids of each frame
TRACKING_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               'golden', 'torch_tracking_golden.npz')
TRACKING_FRAMES = 6
#: per person: start centre (x, y) at GOLDEN_HW, velocity in px per frame
#: and the frames it is in view: person 0 leaves after frame 2, person 3
#: enters at frame 3. Slow enough that some tracks link (the cross-frame
#: edges' CifHr rescoring reads the last CIF field, see
#: ``openpifpaf_tpu_torch/decoder/tracking_pose.py``), so both branches
#: of ``TrackingPose`` run.
TRACKING_PEOPLE = (((120.0, 200.0), (3.0, 1.0), range(0, 3)),
                   ((330.0, 250.0), (-2.0, 2.0), range(0, 6)),
                   ((510.0, 190.0), (2.0, -2.0), range(0, 6)),
                   ((160.0, 390.0), (3.0, -1.0), range(3, 6)))
#: the tracking decoder configurations held against JAX: name -> (CLI
#: flags, the CIF/CAF metas' dataset)
TRACKING_CONFIGS = {
    'default': ((), 'cocokpst'),
    'track_recovery': (('--trackingpose-track-recovery',), 'cocokpst'),
    'single_seed': (('--trackingpose-single-seed',), 'cocokpst'),
    'posetrack2018': ((), 'posetrack2018'),
}
#: small static budgets for the CPU tests (the golden file's decode keeps
#: the defaults)
TRACKING_TEST_BUDGETS = {'n_seeds': 256, 'n_poses': 32}


def tracking_keypoints(n_frames=TRACKING_FRAMES, *, scale=1.0, seed=21):
    """Per frame, {person: (17, 3) keypoints} of TRACKING_PEOPLE, the
    positions and the height (110 px) times ``scale``."""
    import field_fixtures  # imports the JAX package

    rng = np.random.RandomState(seed)
    frames = []
    for t in range(n_frames):
        frame = {}
        for i, ((x0, y0), (vx, vy), alive) in enumerate(TRACKING_PEOPLE):
            if t in alive:
                frame[i] = field_fixtures.synthetic_person(
                    scale * (x0 + vx * t), scale * (y0 + vy * t),
                    scale * 110.0, rng)
        frames.append(frame)
    return frames


def _single_frame_metas(stride, dataset):
    """JAX (Cif, Caf) metas of ``dataset``'s single-image heads at
    ``stride``: the test metas of COCO-17 for cocokpst, the data module's
    for posetrack2018."""
    import field_fixtures  # imports the JAX package
    if dataset == 'cocokpst':
        return field_fixtures.make_metas(stride)
    import openpifpaf_tpu
    cif, caf = openpifpaf_tpu.datasets.factory(dataset).head_metas[:2]
    for i, meta in enumerate((cif, caf)):
        meta.head_index = i
        meta.base_stride = stride
    return cif, caf


def _pair_metas(stride, single_frame_metas):
    """JAX Cif and Caf metas over the two frames' 34 keypoints, the Caf
    with the Tcaf head's cross-frame skeleton: painting a pair of poses
    with them gives the TCAF field (joint 1 in the current frame, joint 2
    in the previous one)."""
    from openpifpaf_tpu import headmeta
    cif = single_frame_metas[0]
    keypoints = list(cif.keypoints) * 2
    sigmas = list(cif.sigmas) * 2
    pose = np.concatenate([cif.pose] * 2)
    n_kp = len(cif.keypoints)
    cif = headmeta.Cif('cif2', 'test', keypoints=keypoints, sigmas=sigmas,
                       pose=pose)
    tcaf = headmeta.Caf('tcaf', 'test', keypoints=keypoints, sigmas=sigmas,
                        pose=pose, skeleton=[(j + 1, j + 1 + n_kp)
                                             for j in range(n_kp)])
    for meta in (cif, tcaf):
        meta.head_index = 0
        meta.base_stride = stride
    return cif, tcaf


def tracking_scene(hw=GOLDEN_HW, stride=GOLDEN_STRIDE, *, scale=1.0,
                   n_frames=TRACKING_FRAMES, seed=21, dataset='cocokpst'):
    """Per frame, the decoded (cif, caf, tcaf) fields of
    :func:`tracking_keypoints`, jittered to be tie-free, for the heads of
    ``dataset`` (cocokpst or posetrack2018). The TCAF field pairs each
    person with itself in the previous frame (in the first frame with
    itself, as the Predictor pairs the first frame with itself)."""
    import field_fixtures  # imports the JAX package

    metas = _single_frame_metas(stride, dataset)
    frames = tracking_keypoints(n_frames, scale=scale, seed=seed)
    out = []
    for t, frame in enumerate(frames):
        anns = [field_fixtures.annotation_dict(k) for k in frame.values()]
        cif, caf, _ = field_fixtures.fields_from_annotations(
            anns, hw, stride=stride, metas=metas)
        prev = frames[max(t - 1, 0)]
        pairs = [field_fixtures.annotation_dict(np.concatenate([k, prev[i]]))
                 for i, k in frame.items() if i in prev]
        _, tcaf, _ = field_fixtures.fields_from_annotations(
            pairs, hw, stride=stride, metas=_pair_metas(stride, metas))
        cif, caf = jitter(cif, caf, seed + 10 * t)
        _, tcaf = jitter(cif[:1], tcaf, seed + 10 * t + 500)
        out.append((cif, caf, tcaf))
    return out


def small_tracking_scene(dataset='cocokpst'):
    """:func:`tracking_scene` at half size (257x321, stride 16) for the
    CPU tests."""
    return tracking_scene((257, 321), GOLDEN_STRIDE, scale=0.5,
                          dataset=dataset)


def _default_field(shape):
    """The decoded field of an empty cell: zeros, the x/y channels at the
    cell's index (CIF: x, y at 2, 3; CAF: at 2, 3 and 4, 5)."""
    n, c, h, w = shape
    out = np.zeros(shape, np.float32)
    ix = np.arange(w, dtype=np.float32)[None, :]
    iy = np.arange(h, dtype=np.float32)[:, None]
    for ch in (2, 4) if c == 8 else (2,):
        out[:, ch] = ix
        out[:, ch + 1] = iy
    return out


def compact_field(field):
    """(flat cell indices, (N, C) values) of the cells of a (F, C, H, W)
    field that differ from :func:`_default_field`."""
    n, c, h, w = field.shape
    cells = field.transpose(0, 2, 3, 1).reshape(-1, c)
    default = _default_field(field.shape).transpose(0, 2, 3, 1).reshape(-1, c)
    index = np.flatnonzero(np.any(cells != default, axis=1))
    return index.astype(np.int32), cells[index]


def expand_field(shape, index, values):
    """The (F, C, H, W) field of :func:`compact_field`'s output."""
    n, c, h, w = shape
    cells = _default_field(shape).transpose(0, 2, 3, 1).reshape(-1, c)
    cells[index] = values
    return np.ascontiguousarray(cells.reshape(n, h, w, c).transpose(
        0, 3, 1, 2))


def tracking_golden_fields(golden):
    """Per frame, the (cif, caf, tcaf) numpy fields of the tracking golden
    file."""
    frames = []
    for t in range(int(golden['n_frames'])):
        frames.append(tuple(
            expand_field(tuple(golden[f'{head}_shape']),
                         golden[f'frame{t}_{head}_index'],
                         golden[f'frame{t}_{head}_values'])
            for head in ('cif', 'caf', 'tcaf')))
    return frames


def jax_tracking_metas(stride, dataset='cocokpst'):
    import openpifpaf_tpu
    metas = openpifpaf_tpu.datasets.factory('cocokpst').head_metas
    for i, m in enumerate(metas):
        m.head_index = i
        m.base_stride = stride
        m.dataset = dataset
    return metas


def port_tracking_metas(stride, dataset='cocokpst'):
    from openpifpaf_tpu_torch.datasets import factory
    from openpifpaf_tpu_torch.models.shell import assign_strides
    metas = assign_strides(factory('cocokpst').head_metas, stride)
    for m in metas:
        m.dataset = dataset
    return metas


def _cifcaf_of(dec):
    """The CifCaf decoder that ``dec`` decodes with."""
    return getattr(dec, 'cifcaf', None) or getattr(dec, 'pose_generator',
                                                   None) or dec


def with_overrides(decoders, overrides):
    """Each decoder of ``decoders`` with ``overrides`` of its CifCaf's
    config."""
    for dec in decoders:
        inner = _cifcaf_of(dec)
        inner.config = dataclasses.replace(inner.config, **overrides)
    return decoders


def _tracking_decoder(decoder, factory_module, metas, flags, overrides,
                      requested):
    """``factory_module.factory(metas, requested)`` while ``flags``
    configure the decoders (their class settings are put back after;
    those that a decoder reads while it decodes are pinned on it first),
    with ``overrides`` of each CifCaf config."""
    parser = argparse.ArgumentParser()
    with restored_statics(*decoder.DECODERS, decoder.TrackBase,
                          decoder.pose_distance.Oks):
        factory_module.cli(parser)
        factory_module.configure(parser.parse_args(list(flags)))
        multi = factory_module.factory(metas, requested)
        for dec in multi.decoders:
            for cls in type(dec).__mro__:
                for k, v in vars(cls).items():
                    if not k.startswith('_') and isinstance(
                            v, (bool, int, float)) and k not in vars(dec):
                        setattr(dec, k, v)
    with_overrides(multi.decoders, overrides or {})
    return multi


def jax_tracking_decoder(stride, flags=(), dataset='cocokpst',
                         overrides=None, requested=None):
    """The JAX package's ``Multi`` of the tracking metas under ``flags``."""
    from openpifpaf_tpu import decoder
    return _tracking_decoder(decoder, decoder.factory,
                             jax_tracking_metas(stride, dataset), flags,
                             overrides, requested)


def port_tracking_decoder(stride, flags=(), dataset='cocokpst',
                          overrides=None, requested=None):
    """The port's ``Multi`` of the tracking metas under ``flags``."""
    from openpifpaf_tpu_torch import decoder
    return _tracking_decoder(decoder, decoder,
                             port_tracking_metas(stride, dataset), flags,
                             overrides, requested)


def reset_port_track_ids():
    """Restart the port's global track-id counter at 1."""
    import itertools
    from openpifpaf_tpu_torch.decoder import track_annotation
    track_annotation._fresh_ids = itertools.count(1)


def reset_track_ids():
    """Restart the global track-id counters of both packages at 1."""
    import itertools
    from openpifpaf_tpu.decoder import track_annotation
    track_annotation._fresh_ids = itertools.count(1)
    reset_port_track_ids()


def track_rows(annotations):
    """(poses (n, n_kp, 4), ids (n,), -1 for none) of a frame's
    annotations."""
    ids = np.asarray([-1 if a.id_ is None else a.id_ for a in annotations],
                     np.int64)
    return pose_rows(annotations), ids


def assert_tracking_frame(annotations, poses, ids, label=''):
    """A frame's annotations against reference rows: the untracked ones
    (id -1, CifCaf's) within the pose gate, each tracked one against the
    reference pose of its id (same ids; visibility equal, xy within 1e-3
    px, confidences within 2e-3)."""
    ours, our_ids = track_rows(annotations)
    assert sorted(our_ids.tolist()) == sorted(np.asarray(ids).tolist()), \
        (label, our_ids, ids)
    assert_pose_gate(list(ours[our_ids == -1]), list(poses[ids == -1]))
    for id_ in our_ids[our_ids != -1]:
        op, = ours[our_ids == id_]
        rp, = poses[ids == id_]
        vis = op[:, 0] > 0
        np.testing.assert_array_equal(vis, rp[:, 0] > 0, err_msg=label)
        np.testing.assert_allclose(op[vis, 1:3], rp[vis, 1:3], atol=1e-3,
                                   err_msg=label)
        np.testing.assert_allclose(op[vis, 0], rp[vis, 0], atol=2e-3,
                                   err_msg=label)


def decode_frames(multi, frames, as_field):
    """Each frame's annotations of ``multi`` (batch 1 per frame);
    ``as_field`` turns a numpy field into the decoder's input."""
    return [multi.batch_decode([as_field(f[None]) for f in fields])[0]
            for fields in frames]


def jax_tracking_golden():
    """The tracking golden file's dict: the frames of :func:`tracking_scene`
    compacted (``frame{t}_{head}_index``/``_values``, ``{head}_shape``) and
    the JAX package's ``Multi`` annotations of each frame under the
    defaults (``frame{t}_poses`` (n, 17, 4), ``frame{t}_ids``, -1 for
    CifCaf's)."""
    reset_track_ids()
    frames = tracking_scene()
    out = {'n_frames': np.int64(len(frames))}
    for head, f in zip(('cif', 'caf', 'tcaf'), frames[0]):
        out[f'{head}_shape'] = np.asarray(f.shape, np.int64)
    for t, fields in enumerate(frames):
        for head, f in zip(('cif', 'caf', 'tcaf'), fields):
            index, values = compact_field(f)
            out[f'frame{t}_{head}_index'] = index
            out[f'frame{t}_{head}_values'] = values
    with jax_f32():
        multi = jax_tracking_decoder(GOLDEN_STRIDE)
        for t, anns in enumerate(decode_frames(multi, frames,
                                               lambda f: f)):
            out[f'frame{t}_poses'], out[f'frame{t}_ids'] = track_rows(anns)
    return out


def write_tracking_golden():
    np.savez_compressed(TRACKING_GOLDEN, **jax_tracking_golden())


def jax_golden():
    """The golden file's dict: :func:`jax_golden_scenes` and
    :func:`jax_golden_config` of each of :func:`golden_configs`."""
    scenes = golden_scenes()
    out = jax_golden_scenes(scenes)
    for scene, config in golden_configs():
        out.update(jax_golden_config(
            scenes, scene, config, out.get(f'{scene}_default_poses')))
    return out


def write_golden():
    np.savez_compressed(GOLDEN, **jax_golden())


if __name__ == '__main__':
    import sys
    import jax
    jax.config.update('jax_platforms', 'cpu')
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if '--tracking' in sys.argv[1:]:
        write_tracking_golden()
        print('wrote', TRACKING_GOLDEN, os.path.getsize(TRACKING_GOLDEN),
              'bytes')
    else:
        write_golden()
        print('wrote', GOLDEN, os.path.getsize(GOLDEN), 'bytes')
