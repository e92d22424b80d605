"""Predictor and predict CLI of the PyTorch port against the JAX package.

A narrow ShuffleNetV2K with random flax weights, bridged to the port,
serves the same uint8 images through both ``Predictor.numpy_images``:
the fields must agree (atol 1e-4, float32 convolutions in two frameworks)
and the annotation lists must be equal. The confidence biases of the
heads are raised and the seed, keypoint and instance thresholds lowered
(``THRESHOLDS``) so that the decode of these random-weight fields keeps
poses to compare.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openpifpaf_tpu
from openpifpaf_tpu.decoder.cifcaf import CifCaf as JaxCifCaf
from openpifpaf_tpu.models import basenetworks as jax_base
from openpifpaf_tpu.models.heads import CompositeField4 as JaxCompositeField4
from openpifpaf_tpu.models.shell import Shell as JaxShell, \
    assign_strides as jax_assign_strides
from openpifpaf_tpu_torch.decoder import CifCaf as TorchCifCaf
from openpifpaf_tpu_torch.models import basenetworks, convert_jax
from openpifpaf_tpu_torch.models.factory import Factory
from openpifpaf_tpu_torch.plugins.coco.constants import cocokp_head_metas
from openpifpaf_tpu_torch.predictor import Predictor

from torch_port_helpers import jax_f32, one_torch_thread

NARROW = ([1, 2, 1], [8, 16, 32, 64, 64])
THRESHOLDS = {'seed_threshold': 0.05, 'keypoint_threshold_nms': 0.05,
              'instance_threshold': 0.001}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    one_torch_thread()


@pytest.fixture(scope='module')
def predictors():
    metas = openpifpaf_tpu.datasets.factory('cocokp').head_metas
    base = jax_base.ShuffleNetV2K(stages_repeats=NARROW[0],
                                  stages_out_channels=NARROW[1])
    jax_assign_strides(metas, base.stride)
    model = JaxShell(base_net=base, head_nets=tuple(
        JaxCompositeField4(meta=m) for m in metas))
    variables = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 65, 65, 3)), train=True))
    for i, meta in enumerate(metas):  # confidence channels: bias +2
        bias = variables['params'][f'head_nets_{i}']['Conv_0']['bias']
        bias = bias.reshape(meta.n_fields, meta.n_components).copy()
        bias[:, 1] += 2.0
        variables['params'][f'head_nets_{i}']['Conv_0']['bias'] = \
            bias.reshape(-1)

    torch_model = Factory().from_scratch(
        cocokp_head_metas(), base_net=basenetworks.ShuffleNetV2K(*NARROW))
    convert_jax.load_jax_variables(torch_model, variables)

    # the decoders read their class-level thresholds when constructed
    saved = {(cls, k): getattr(cls, k) for cls in (JaxCifCaf, TorchCifCaf)
             for k in THRESHOLDS}
    for cls, k in saved:
        setattr(cls, k, THRESHOLDS[k])
    try:
        jax_predictor = openpifpaf_tpu.Predictor(model=model,
                                                 variables=variables)
        port = Predictor(model=torch_model, device='cpu')
    finally:
        for (cls, k), value in saved.items():
            setattr(cls, k, value)
    jax_predictor.pipeline_decode = False
    return jax_predictor, port


def _images(n, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (97, 129, 3), dtype=np.uint8)
            for _ in range(n)]


def test_fields_match_jax_predictor(predictors):
    jax_predictor, port = predictors
    batch = np.stack([port.preprocess(im, [], None)[0]
                      for im in _images(2, seed=0)])
    with jax_f32():
        ref = jax_predictor.fields_batch(batch)
    out = port.fields_batch(batch)
    assert [tuple(o.shape) for o in out] == [r.shape for r in ref] == [
        (2, 17, 5, 9, 9), (2, 19, 8, 9, 9)]
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-4,
                                   rtol=0)


@pytest.mark.parametrize('batch_size', [1, 2])
def test_annotations_match_jax_predictor(predictors, batch_size):
    jax_predictor, port = predictors
    images = _images(2, seed=1)
    jax_predictor.batch_size = port.batch_size = batch_size
    with jax_f32():
        ref = [[a.json_data() for a in pred]
               for pred, _, _ in jax_predictor.numpy_images(images)]
    out = [[a.json_data() for a in pred]
           for pred, _, _ in port.numpy_images(images)]
    assert len(out) == len(ref) == 2
    assert sum(len(anns) for anns in ref) > 0
    for ours, theirs in zip(out, ref):
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            # json_data rounds coordinates to 2 digits and scores to 3: a
            # last-bit float difference may land one rounding step apart
            np.testing.assert_allclose(a['keypoints'], b['keypoints'],
                                       atol=0.0101, rtol=0)
            np.testing.assert_allclose(a['bbox'], b['bbox'], atol=0.0101,
                                       rtol=0)
            assert abs(a['score'] - b['score']) <= 0.00101
            assert a['category_id'] == b['category_id']


def test_predict_cli_writes_json(tmp_path):
    """``python -m openpifpaf_tpu_torch.predict`` on JPEG files, with the
    default random-init shufflenetv2k16."""
    import PIL.Image

    names = []
    for i, image in enumerate(_images(2, seed=2)):
        name = str(tmp_path / f'image{i}.jpg')
        PIL.Image.fromarray(image).save(name)
        names.append(name)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    done = subprocess.run(
        [sys.executable, '-m', 'openpifpaf_tpu_torch.predict', *names,
         '--long-edge', '97', '--batch-size', '2', '--json-output',
         str(tmp_path)],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=600, check=False)
    assert done.returncode == 0, done.stderr
    for name in names:
        with open(os.path.join(str(tmp_path), os.path.basename(name))
                  + '.predictions.json') as f:
            predictions = json.load(f)
        assert isinstance(predictions, list)
        for ann in predictions:
            assert len(ann['keypoints']) == 17 * 3
            assert set(ann) == {'keypoints', 'bbox', 'score', 'category_id'}


def test_checkpoint_is_not_yet_ported():
    """Only the random-init model runs: a checkpoint raises at once."""
    from openpifpaf_tpu_torch import predict

    with pytest.raises(NotImplementedError, match='ROADMAP'):
        predict.main(['image.jpg', '--checkpoint', 'model.arrays'])
