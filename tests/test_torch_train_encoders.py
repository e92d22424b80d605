"""The port's CIF and CAF encoders against the JAX package's.

The scenes of ``tools/capture_encoder_golden.py`` (overlapping people,
hidden keypoints, crowds, out-of-bounds joints, valid-area masks,
degenerate instances) go through the port's ``Cif`` and ``Caf`` (dense
CAF too, and the Caf and rescaler flag variants). Each target must equal,
bit for bit (NaN where NaN), a fresh run of the JAX encoder on the same
scene and the matching entry of ``tests/golden/encoder_golden.npz``.
"""

import importlib.util
import os

import numpy as np
import pytest

from openpifpaf_tpu import encoder as jax_encoder
from openpifpaf_tpu import headmeta as jax_headmeta
from openpifpaf_tpu.plugins.coco import constants as jax_constants
from openpifpaf_tpu_torch import encoder, headmeta
from openpifpaf_tpu_torch.plugins.coco import constants

from torch_port_helpers import restored_statics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, 'tests', 'golden', 'encoder_golden.npz')


@pytest.fixture(scope='module')
def capture():
    spec = importlib.util.spec_from_file_location(
        'capture_encoder_golden',
        os.path.join(ROOT, 'tools', 'capture_encoder_golden.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope='module')
def golden():
    return dict(np.load(GOLDEN))


def _metas(hm, cst, kind):
    """(cif, caf, dense caf) metas at stride 8, as the capture script
    builds them (``field_fixtures.make_metas`` and its dense meta)."""
    common = dict(keypoints=cst.COCO_KEYPOINTS, sigmas=cst.COCO_PERSON_SIGMAS,
                  pose=cst.COCO_UPRIGHT_POSE)
    metas = {
        'cif': hm.Cif('cif', 'test', score_weights=cst.COCO_PERSON_SCORE_WEIGHTS,
                      **common),
        'caf': hm.Caf('caf', 'test', skeleton=cst.COCO_PERSON_SKELETON,
                      **common),
        'cafdense': hm.Caf('caf25', 'test',
                           skeleton=cst.DENSER_COCO_PERSON_SKELETON,
                           sparse_skeleton=cst.COCO_PERSON_SKELETON,
                           only_in_field_of_view=True, **common),
    }
    meta = metas[kind]
    meta.base_stride = 8
    return meta


def _encode(package, kind, image, anns, meta):
    hm, cst = ((headmeta, constants) if package is encoder
               else (jax_headmeta, jax_constants))
    head_meta = _metas(hm, cst, kind)
    anns = [dict(a, keypoints=a['keypoints'].copy()) for a in anns]
    cls = package.Cif if kind == 'cif' else package.Caf
    return cls(head_meta)(image, anns, meta)


SCENES = [(kind, i) for kind in ('cif', 'caf', 'cafdense') for i in range(3)]


@pytest.mark.parametrize('kind,scene', SCENES)
def test_scene_targets_equal_jax_and_golden(capture, golden, kind, scene):
    image_hw, scenes = capture.scenes()
    image = np.zeros((image_hw[0], image_hw[1], 3), dtype=np.float32)
    anns, meta = scenes[scene]
    ours = _encode(encoder, kind, image, anns, meta)
    ref = _encode(jax_encoder, kind, image, anns, meta)
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, golden[f'{kind}_{scene}'])
    assert np.nansum(ours[:, 0]) > 0


VARIANTS = [
    ('caf_variant_fixed', 'caf', 'Caf', {'fixed_size': True}),
    ('caf_variant_aspect', 'caf', 'Caf', {'aspect_ratio': 0.3}),
    ('caf_variant_minsz5', 'caf', 'Caf', {'min_size': 5}),
    ('cif_rescaler_collision', 'cif', 'AnnRescaler',
     {'suppress_collision': True}),
    ('cif_rescaler_invisible', 'cif', 'AnnRescaler',
     {'suppress_invisible': True}),
    ('cif_rescaler_noselfhidden', 'cif', 'AnnRescaler',
     {'suppress_selfhidden': False}),
]


@pytest.mark.parametrize('key,kind,cls,attrs', VARIANTS,
                         ids=[v[0] for v in VARIANTS])
def test_flag_variants_equal_jax_and_golden(capture, golden, key, kind, cls,
                                            attrs):
    image_hw, scenes = capture.scenes()
    image = np.zeros((image_hw[0], image_hw[1], 3), dtype=np.float32)
    anns, meta = scenes[0]
    out = {}
    for package in (encoder, jax_encoder):
        target = getattr(package, cls)
        with restored_statics(target):
            for k, v in attrs.items():
                setattr(target, k, v)
            out[package] = _encode(package, kind, image, anns, meta)
    np.testing.assert_array_equal(out[encoder], out[jax_encoder])
    np.testing.assert_array_equal(out[encoder], golden[key])


def test_encoder_flags_match_jax():
    """``--cif-side-length`` etc.: the same flags, defaults and targets."""
    import argparse
    parsers = []
    for package in (encoder, jax_encoder):
        parser = argparse.ArgumentParser()
        package.cli(parser)
        parsers.append(parser)
    argv = ['--cif-side-length', '5', '--caf-min-size', '4',
            '--caf-fixed-size', '--encoder-suppress-invisible']
    ours, ref = (vars(p.parse_args(argv)) for p in parsers)
    assert ours == ref
    with restored_statics(encoder.Cif, encoder.Caf, encoder.AnnRescaler):
        encoder.configure(parsers[0].parse_args(argv))
        assert (encoder.Cif.side_length, encoder.Caf.min_size,
                encoder.Caf.fixed_size,
                encoder.AnnRescaler.suppress_invisible) == (5, 4, True, True)
