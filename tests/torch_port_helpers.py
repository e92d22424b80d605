"""Shared pieces of the PyTorch-port parity tests (``test_torch_*.py``).

The JAX package is the reference: each test feeds the same numpy inputs,
made from a seed, to a JAX function and to its port. The JAX side runs
under ``jax.default_matmul_precision('float32')`` because this JAX build's
CPU default matmul precision is bf16-class.

This module also owns ``golden/torch_decode_golden.npz``: decoded fields of
two 513x641 scenes at stride 16 (3 people, and 40 people, which overflows
the fast tier) with the JAX ``CifCaf`` poses. ``chip_smoke.py`` and
``test_torch_cuda.py`` decode them with the port on the GPU, where JAX is
not installed, so this module imports JAX only inside the functions that
use it. Run this file to write the golden file anew:

    JAX_PLATFORMS=cpu python tests/torch_port_helpers.py
"""

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
              origin=(60.0, 90.0)):
    """Decoded CIF/CAF fields of ``n_people`` upright people on a grid,
    jittered to be tie-free."""
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
    return jitter(cif, caf, seed)


def sparse_scene(seed=0):
    """3 people, stride 8: decodes at the fast tier."""
    return row_scene(3, (169, 257), 8, height=90.0, seed=seed)


def crowd_scene(seed=7):
    """12 people, stride 8: overflows the fast tier's seed budget, so the
    decoder escalates to the crowd tier."""
    return row_scene(12, (169, 257), 8, height=45.0, seed=seed,
                     spacing=(45.0, 60.0), origin=(30.0, 40.0))


def golden_scenes():
    """The two scenes of the golden file, fields at stride 16."""
    sparse = row_scene(3, GOLDEN_HW, GOLDEN_STRIDE, height=110.0, seed=11,
                       spacing=(170.0, 90.0), origin=(90.0, 140.0))
    crowd = row_scene(40, GOLDEN_HW, GOLDEN_STRIDE, height=65.0, seed=13,
                      spacing=(75.0, 90.0), origin=(35.0, 60.0))
    return {'sparse': sparse, 'crowd': crowd}


def jax_metas(stride):
    import openpifpaf_tpu
    cif, caf = openpifpaf_tpu.datasets.factory('cocokp').head_metas
    for i, m in enumerate((cif, caf)):
        m.head_index = i
        m.base_stride = stride
    return cif, caf


def port_metas(stride):
    from openpifpaf_tpu_torch.models.shell import assign_strides
    from openpifpaf_tpu_torch.plugins.coco.constants import cocokp_head_metas
    return assign_strides(cocokp_head_metas(), stride)


def jax_cifcaf(stride, cifhr_impl='auto'):
    """The JAX package's CifCaf decoder with the given CifHr impl."""
    import dataclasses
    from openpifpaf_tpu.decoder.cifcaf import CifCaf
    dec = CifCaf(*jax_metas(stride))
    dec.config = dataclasses.replace(dec.config, cifhr_impl=cifhr_impl)
    return dec


def kept_poses(poses, keep, order):
    """The kept (n_kp, 4) [v, x, y, s] poses in score order."""
    poses, keep, order = (np.asarray(a) for a in (poses, keep, order))
    return [poses[i] for i in order if keep[i]]


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


def jax_golden():
    """Fields and JAX CifCaf (default config) outputs of the golden
    scenes, as the dict stored in the golden file."""
    scenes = golden_scenes()
    dec = jax_cifcaf(GOLDEN_STRIDE)
    out = {}
    with jax_f32():
        for name, (cif, caf) in scenes.items():
            poses, keep, order = dec._decode_adaptive(
                GOLDEN_STRIDE, (cif[None], caf[None]))
            kept = kept_poses(np.asarray(poses)[0], np.asarray(keep)[0],
                              np.asarray(order)[0])
            out[f'{name}_cif'] = cif
            out[f'{name}_caf'] = caf
            out[f'{name}_poses'] = np.asarray(kept, np.float32).reshape(
                -1, cif.shape[0], 4)
    return out


def write_golden():
    np.savez_compressed(GOLDEN, **jax_golden())


if __name__ == '__main__':
    import jax
    jax.config.update('jax_platforms', 'cpu')
    write_golden()
    print('wrote', GOLDEN, os.path.getsize(GOLDEN), 'bytes')
