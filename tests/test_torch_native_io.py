"""The port's native JPEG loader (``openpifpaf_tpu_torch/io/native.py``,
its own copy of ``pifpaf_io.cpp`` built with ``g++`` and the JAX package's
flags into the port's build directory) against the JAX package's
``NativeImageLoader``, and the port's ``Predictor`` on it.

- On synthetic JPEGs written with PIL from a seed, ``load_batch`` and
  ``load_batch_uint8`` equal JAX's byte for byte (same source, same flags,
  same machine), and the metas are equal.
- The native batch is within ``test_native_io.py::test_close_to_pil``'s
  tolerance (mean absolute difference below 0.5) of the PIL path's.
- ``Predictor`` takes the native path under JAX's conditions only (JPEG
  files, a ``long_edge``, ``native_io``, not tracking), and its poses on
  that path pass the tie-free pose gate against JAX's ``Predictor`` on its
  native path (the posed narrow shell, fields within float rounding).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest

import openpifpaf_tpu
from openpifpaf_tpu import transforms as jax_transforms
from openpifpaf_tpu.io import native as jax_native
from openpifpaf_tpu.models.heads import CompositeField4
from openpifpaf_tpu.models.shell import Shell
from openpifpaf_tpu_torch import _nvcc
from openpifpaf_tpu_torch.io import native
from openpifpaf_tpu_torch.models import basenetworks, convert_jax
from openpifpaf_tpu_torch.models.factory import Factory
from openpifpaf_tpu_torch.plugins.coco.constants import cocokp_head_metas
from openpifpaf_tpu_torch.predictor import Predictor

from torch_port_helpers import NARROW, assert_pose_gate, jax_f32, \
    one_torch_thread, pose_rows, posed_head

#: (height, width) of the synthetic JPEGs: landscape, portrait, square
SIZES = ((180, 320), (240, 200), (97, 97), (120, 161))
LONG_EDGE = 129


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    one_torch_thread()


@pytest.fixture(scope='module')
def jpegs(tmp_path_factory):
    """Smooth random images (so that JPEG keeps detail) saved as JPEGs."""
    directory = tmp_path_factory.mktemp('jpegs')
    rng = np.random.RandomState(0)
    paths = []
    for i, (h, w) in enumerate(SIZES):
        coarse = rng.randint(0, 256, (h // 8 + 2, w // 8 + 2, 3)).astype(
            np.uint8)
        image = PIL.Image.fromarray(coarse).resize((w, h),
                                                   PIL.Image.BILINEAR)
        noise = rng.randint(-12, 13, (h, w, 3))
        pixels = np.clip(np.asarray(image, np.int32) + noise, 0, 255)
        path = str(directory / f'image{i}.jpg')
        PIL.Image.fromarray(pixels.astype(np.uint8)).save(path, quality=90)
        paths.append(path)
    return paths


def _assert_metas_equal(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                np.testing.assert_array_equal(a[k], b[k])
            else:
                assert a[k] == b[k], k


def test_library_builds_into_the_build_directory():
    path = native.build()
    assert os.path.dirname(path) == _nvcc.BUILD_DIR
    assert os.path.basename(path).startswith('libpifpaf_io_')
    assert native.native_available()


@pytest.mark.parametrize('long_edge', [LONG_EDGE, 161])
@pytest.mark.parametrize('method', ['load_batch', 'load_batch_uint8'])
def test_batches_equal_jax_byte_for_byte(jpegs, method, long_edge):
    ours = getattr(native.NativeImageLoader(long_edge=long_edge),
                   method)(jpegs)
    ref = getattr(jax_native.NativeImageLoader(long_edge=long_edge),
                  method)(jpegs)
    assert ours[0].dtype == ref[0].dtype
    assert ours[0].shape == ref[0].shape == (len(jpegs), long_edge,
                                             long_edge, 3)
    assert ours[0].tobytes() == ref[0].tobytes()
    _assert_metas_equal(ours[1], ref[1])


def test_native_batch_close_to_pil(jpegs):
    images, metas = native.NativeImageLoader(
        long_edge=LONG_EDGE).load_batch(jpegs)
    pre = jax_transforms.Compose([
        jax_transforms.NormalizeAnnotations(),
        jax_transforms.RescaleAbsolute(LONG_EDGE),
        jax_transforms.EVAL_TRANSFORM,
    ])
    for image, meta, path in zip(images, metas, jpegs):
        with open(path, 'rb') as f:
            pil = PIL.Image.open(f).convert('RGB')
        pim, _, _ = pre(pil, [], {})
        sh, sw = pim.shape[:2]
        assert meta['scaled_wh'] == (sw, sh)
        assert float(np.abs(image[:sh, :sw] - pim).mean()) < 0.5


@pytest.fixture(scope='module')
def predictors():
    """(JAX's, the port's) Predictor of one posed narrow shell
    (``posed_head`` weights, bridged), both on their native paths."""
    metas = openpifpaf_tpu.datasets.factory('cocokp').head_metas
    base = openpifpaf_tpu.models.basenetworks.ShuffleNetV2K(
        stages_repeats=NARROW[0], stages_out_channels=NARROW[1])
    openpifpaf_tpu.models.shell.assign_strides(metas, base.stride)
    model = Shell(base_net=base, head_nets=tuple(
        CompositeField4(meta=m) for m in metas))
    variables = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 65, 65, 3)), train=True))
    for i, meta in enumerate(metas):
        conv = variables['params'][f'head_nets_{i}']['Conv_0']
        conv['kernel'], conv['bias'] = posed_head(conv['kernel'],
                                                  conv['bias'], meta)
    port_model = Factory().from_scratch(
        cocokp_head_metas(), base_net=basenetworks.ShuffleNetV2K(*NARROW))
    port_model.load_state_dict(convert_jax.state_dict_from_jax(variables),
                               strict=True)
    jax_predictor = openpifpaf_tpu.Predictor(model=model,
                                             variables=variables)
    port = Predictor(model=port_model, device='cpu')
    for p in (jax_predictor, port):
        p.long_edge = LONG_EDGE
        p.preprocess = p._build_preprocess()
    return jax_predictor, port


@pytest.mark.parametrize('case', ['native', 'no_native_io', 'no_long_edge',
                                  'png', 'tracking'])
def test_predictor_takes_the_native_path_under_jax_conditions(
        predictors, jpegs, tmp_path, case, monkeypatch):
    files = list(jpegs[:2])
    if case == 'png':
        files.append(str(tmp_path / 'x.png'))
    for p in predictors:
        if case == 'no_native_io':
            monkeypatch.setattr(p, 'native_io', False)
        if case == 'no_long_edge':
            monkeypatch.setattr(p, 'long_edge', None)
        if case == 'tracking':
            monkeypatch.setattr(p, '_tracking', True)
    jax_loader, port_loader = (p._native_loader(files) for p in predictors)
    assert (port_loader is None) == (jax_loader is None)
    assert (port_loader is not None) == (case == 'native')


def test_predictor_native_poses_match_jax(predictors, jpegs):
    jax_predictor, port = predictors
    with jax_f32():
        ref = list(jax_predictor.images(jpegs))
    ours = list(port.images(jpegs))
    assert port.last_image_loader == 'native'
    assert sum(len(anns) for anns, _, _ in ours) >= len(jpegs)
    for (anns, _, meta), (ref_anns, _, ref_meta) in zip(ours, ref):
        assert meta['file_name'] == ref_meta['file_name']
        np.testing.assert_array_equal(meta['scale'], ref_meta['scale'])
        assert_pose_gate(pose_rows(anns), pose_rows(ref_anns))


def test_predictor_pil_path_when_not_native(predictors, jpegs, monkeypatch):
    port = predictors[1]
    monkeypatch.setattr(port, 'native_io', False)
    out = list(port.images(jpegs[:1]))
    assert port.last_image_loader == 'pil' and len(out) == 1
