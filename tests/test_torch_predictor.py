"""Predictor and predict CLI of the PyTorch port against the JAX package.

A narrow ShuffleNetV2K with random flax weights, bridged to the port,
serves the same uint8 images through both ``Predictor.numpy_images``:
the fields must agree (atol 1e-4, float32 convolutions in two frameworks)
and the annotation lists must be equal. Each backbone engine of the port
gives the fields of its module graph (atol 1e-5) and of the JAX Predictor's
flax graph. The confidence biases of the
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
from torch import nn

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

from torch_port_helpers import NARROW, jax_f32, one_torch_thread

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
    jax_predictor.backbone_engine = 'flax'
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


def _batch(port):
    return np.stack([port.preprocess(im, [], None)[0]
                     for im in _images(2, seed=0)])


@pytest.mark.parametrize('engine', ['folded', 'dwpallas', 'pallas',
                                    'halves', 'stencil'])
def test_engine_fields_match_module_graph_and_jax(predictors, engine):
    jax_predictor, port = predictors
    engine_port = Predictor(model=port.model, device='cpu',
                            backbone_engine=engine)
    assert engine_port._backbone is not None
    batch = _batch(port)
    with jax_f32():
        ref = jax_predictor.fields_batch(batch)
    module = port.fields_batch(batch)
    out = engine_port.fields_batch(batch)
    for o, m, r in zip(out, module, ref):
        np.testing.assert_allclose(o.numpy(), m.numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-4,
                                   rtol=0)


@pytest.mark.parametrize('engine', ['flax', 'pallas'])
def test_bf16_backbone_fields_close_to_float32(predictors, engine):
    """bfloat16 backbone, float32 heads: finite fields within 5% of the
    largest float32 value of each head."""
    _, port = predictors
    bf16 = Predictor(model=port.model, device='cpu', backbone_engine=engine,
                     bf16=True)
    batch = _batch(port)
    for o, r in zip(bf16.fields_batch(batch), port.fields_batch(batch)):
        assert o.dtype == torch.float32
        assert bool(torch.isfinite(o).all())
        assert float((o - r).abs().max()) <= 0.05 * float(r.abs().max())


def test_auto_engine_policy():
    """'auto' keeps k16 (174-channel halves) on the module graph and takes
    'halves' (the folded graph) when every stage's halves are
    128-multiples, as in ``tests/test_shuffle_pallas.py``."""
    k16 = Predictor(device='cpu')
    assert k16.backbone_engine == 'auto'
    assert k16._backbone is None

    aligned = Factory().from_scratch(
        cocokp_head_metas(), base_net=basenetworks.ShuffleNetV2K(
            [2, 2, 2], [16, 256, 256, 256, 256]))
    auto = Predictor(model=aligned, device='cpu')
    assert auto._backbone is not None
    module = Predictor(model=aligned, device='cpu', backbone_engine='flax')
    image = np.random.RandomState(2).randn(1, 33, 49, 3).astype(np.float32)
    auto.size_bucket = module.size_bucket = 0
    for o, r in zip(auto.fields_batch(image), module.fields_batch(image)):
        np.testing.assert_allclose(o.numpy(), r.numpy(), atol=2e-5,
                                   rtol=2e-4)


class _ConvNet(nn.Module):
    """A backbone that is not a ShuffleNetV2K."""
    stride = 16
    out_features = 8

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 8, 16, stride=16)

    def forward(self, x):
        return self.conv(x)


@pytest.mark.parametrize('engine', ['folded', 'dwpallas', 'pallas',
                                    'halves', 'stencil'])
def test_explicit_engine_on_unfoldable_backbone_raises(engine):
    model = Factory().from_scratch(cocokp_head_metas(), base_net=_ConvNet())
    assert Predictor(model=model, device='cpu')._backbone is None  # auto
    with pytest.raises(ValueError, match='only a ShuffleNetV2K'):
        Predictor(model=model, device='cpu', backbone_engine=engine)


def test_predict_cli_passes_engine_and_bf16(monkeypatch):
    from openpifpaf_tpu_torch import predict

    seen = []

    class Recorder:
        def __init__(self, **kwargs):
            seen.append(kwargs)

        def _build_preprocess(self):
            return None

        def images(self, names):
            return iter(())

    monkeypatch.setattr(predict, 'Predictor', Recorder)
    predict.main(['image.jpg', '--backbone-engine', 'pallas', '--bf16'])
    predict.main(['image.jpg', '--device', 'cpu'])
    assert [(s['backbone_engine'], s['bf16'], s['device']) for s in seen] == [
        ('pallas', True, 'cuda'), ('auto', False, 'cpu')]
    with pytest.raises(SystemExit):
        predict.cli(['image.jpg', '--backbone-engine', 'cudnn'])


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
         '--long-edge', '97', '--batch-size', '2', '--device', 'cpu',
         '--json-output', str(tmp_path)],
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


def test_predictor_without_cuda_raises(monkeypatch):
    """No silent CPU fallback: without a CUDA device the default device
    raises, and the CPU runs only when asked for."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    model = Factory().from_scratch(
        cocokp_head_metas(), base_net=basenetworks.ShuffleNetV2K(*NARROW))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(model=model)
    assert Predictor(model=model, device='cpu').device.type == 'cpu'


def test_checkpoint_is_not_yet_ported(tmp_path):
    """The port reads its own checkpoints (``.json`` + ``.pt``); a JAX
    orbax checkpoint (``.json`` + ``.arrays/``) raises at once, naming the
    converter that runs where the JAX package is installed."""
    from openpifpaf_tpu_torch import predict

    base = str(tmp_path / 'model')
    with open(base + '.json', 'w') as f:
        json.dump({'base_name': 'shufflenetv2k16', 'head_metas': []}, f)
    os.makedirs(base + '.arrays')
    with pytest.raises(NotImplementedError,
                       match='tools/convert_jax_checkpoint.py'):
        predict.main(['image.jpg', '--checkpoint', base])
