"""``tools/convert_jax_checkpoint.py``: a checkpoint of the JAX package
(``.json`` and the orbax ``.arrays``) into one of the PyTorch port.

The committed orbax fixture (a resnet18 without its last block, overfit
on one image) is converted by the tool's command line; the port loads the
result, its meta is the JAX meta as it was, and the port's ``predict``
serves it. The fields of the port's ``Predictor`` on the converted
checkpoint equal those of the JAX package's ``load_shell`` forward within
1e-4 of each head's largest value (float32 convolutions in two
frameworks; the JAX side at float32 matmul precision). The port itself
still refuses an orbax directory, naming the tool.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest

from openpifpaf_tpu.training import checkpoint as jax_checkpoint
from openpifpaf_tpu_torch import decoder, predict
from openpifpaf_tpu_torch.predictor import Predictor
from openpifpaf_tpu_torch.training import checkpoint

from test_torch_fixture_checkpoint import fixture_image
from torch_port_helpers import FIXTURE, jax_f32, one_torch_thread, \
    restored_statics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, 'tools', 'convert_jax_checkpoint.py')


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    one_torch_thread()


@pytest.fixture(scope='module')
def converted(tmp_path_factory):
    dst = str(tmp_path_factory.mktemp('converted') / 'fixture')
    env = dict(os.environ, JAX_PLATFORMS='cpu', OMP_NUM_THREADS='1')
    done = subprocess.run([sys.executable, TOOL, FIXTURE, dst], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    assert done.stdout.strip().splitlines()[-1] == dst
    return dst


def test_converted_checkpoint_loads_with_the_jax_meta(converted):
    state_dict, meta = checkpoint.load(converted)
    with open(FIXTURE + '.json') as f:
        assert meta == json.load(f)
    model, _ = checkpoint.load_shell(converted)
    assert set(model.state_dict()) == set(state_dict)
    assert [m.name for m in model.head_metas] == ['cif', 'caf']


def test_converted_fields_equal_jax(converted):
    """The port's Predictor on the converted checkpoint against JAX's
    ``load_shell`` forward, on the fixture's synthetic image."""
    predictor = Predictor(checkpoint=converted, device='cpu')
    batch = predictor.preprocess(fixture_image(), [], None)[0][None]
    fields = predictor.fields_batch(batch)
    model, variables = jax_checkpoint.load_shell(FIXTURE)
    with jax_f32():
        ref = model.apply(variables, jnp.asarray(predictor._bucket_pad(batch)),
                          train=False)
    assert [tuple(f.shape) for f in fields] == [r.shape for r in ref]
    for f, r in zip(fields, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(f.numpy(), r, atol=1e-4 * np.abs(r).max(),
                                   rtol=0)


def test_predict_serves_the_converted_checkpoint(converted, tmp_path):
    image = str(tmp_path / 'image.png')
    PIL.Image.fromarray(fixture_image()).save(image)
    with restored_statics(*decoder.DECODERS):
        predict.main([image, '--checkpoint', converted, '--device', 'cpu',
                      '--force-complete-pose', '--json-output',
                      str(tmp_path)])
    with open(image + '.predictions.json') as f:
        predictions = json.load(f)
    assert len(predictions) == 1
    assert len(predictions[0]['keypoints']) == 17 * 3


def test_port_refuses_orbax_and_names_the_tool():
    with pytest.raises(NotImplementedError,
                       match='tools/convert_jax_checkpoint.py'):
        checkpoint.load(FIXTURE)
