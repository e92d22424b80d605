"""The committed *trained* checkpoint of the JAX package through the port.

``tests/fixtures/overfit_fixture`` is an orbax checkpoint of a resnet18
without its last block (stride 8), overfit on one image. Its variables go
through ``convert_jax.state_dict_from_jax`` into the port's ``Shell``;
then the port's fields, poses and served predictions must be JAX's. The
image the fixture was trained on is not in the repo, so the input is a
synthetic one: dark noise with a bright square, on which the trained
model's fields peak (CIF confidences above 0.9). Its CAF scores there stay
below the default ``--caf-th``, so the poses are compared under
``--force-complete-pose``, which completes the one pose that the model
finds.

Tolerances: fields within 1e-4 of each head's largest value (float32
convolutions in two frameworks; the JAX side at float32 matmul
precision); poses by the decode gate of ``ROADMAP.md`` (counts and
visibility equal, locations within 1e-3 px, confidences within 2e-3).
"""

import argparse
import functools

import jax
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

from openpifpaf_tpu import decoder as jax_decoder_module
from openpifpaf_tpu.predictor import Predictor as JaxPredictor
from openpifpaf_tpu.training import checkpoint as jax_checkpoint
from openpifpaf_tpu_torch import decoder as port_decoder_module
from openpifpaf_tpu_torch.models import basenetworks, convert_jax
from openpifpaf_tpu_torch.models import factory as port_factory
from openpifpaf_tpu_torch.models.shell import assign_strides
from openpifpaf_tpu_torch.predictor import Predictor
from openpifpaf_tpu_torch.training import checkpoint as port_checkpoint

from torch_port_helpers import FIXTURE, assert_pose_gate, jax_decoder, \
    jax_f32, one_torch_thread, orbax_to_port_checkpoint, port_decoder, \
    pose_rows, restored_statics

FLAGS = ('--force-complete-pose',)
LONG_EDGE = 161
STRIDE = 8


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    one_torch_thread()


def fixture_image():
    rng = np.random.RandomState(0)
    image = rng.randint(0, 32, (LONG_EDGE, LONG_EDGE, 3)).astype(np.uint8)
    image[80:140, 80:140] = 200
    return image


@pytest.fixture(scope='module')
def jax_shell():
    return jax_checkpoint.load_shell(FIXTURE)


@pytest.fixture(scope='module')
def port_shell(jax_shell):
    """The port's Shell built as the checkpoint's meta says, with the
    bridged variables."""
    _, variables = jax_shell
    _, meta = jax_checkpoint.load(FIXTURE)
    assert meta['base_name'] == 'resnet18'
    assert meta['backbone_options']['resnet']['remove_last_block']
    base = basenetworks.Resnet((2, 2, 2, 2), base_features=64,
                               basic_block=True, remove_last_block=True)
    metas = assign_strides([port_checkpoint.headmeta_from_dict(d)
                            for d in meta['head_metas']], base.stride)
    model = port_factory.build_shell(base, metas)
    convert_jax.load_jax_variables(model, jax.tree_util.tree_map(
        np.asarray, variables))
    return model.eval()


@pytest.fixture(scope='module')
def fields(jax_shell, port_shell):
    """(JAX's, the port's) fields of the preprocessed fixture image."""
    predictor = Predictor(model=port_shell, device='cpu')
    predictor.long_edge = LONG_EDGE
    image, _, _ = predictor._build_preprocess()(
        PIL.Image.fromarray(fixture_image()), [], {'dataset_index': 0})
    batch = np.asarray(image, np.float32)[None]
    model, variables = jax_shell
    with jax_f32():
        ref = jax.jit(functools.partial(model.apply, train=False))(
            variables, jnp.asarray(batch))
    with torch.no_grad():
        ours = port_shell(torch.from_numpy(batch))
    return [np.asarray(r) for r in ref], [o.numpy() for o in ours]


def test_fixture_fields_match_jax(port_shell, fields):
    assert port_shell.base_net.stride == STRIDE
    ref, ours = fields
    assert [r.shape for r in ref] == [o.shape for o in ours]
    assert float(ref[0][0, :, 1].max()) > 0.9  # the trained model responds
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o, r, atol=1e-4 * np.abs(r).max(),
                                   rtol=0)


def test_fixture_poses_match_jax(fields):
    """Each side's own fields through its own decoder."""
    ref, ours = fields
    jax_anns = jax_decoder(STRIDE, FLAGS).batch_decode(
        [jnp.asarray(f) for f in ref])[0]
    port_anns = port_decoder(STRIDE, FLAGS).batch_decode(
        [torch.from_numpy(f) for f in ours])[0]
    assert len(jax_anns) == 1
    assert int((jax_anns[0].data[:, 2] > 0).sum()) >= 10
    assert_pose_gate(pose_rows(port_anns)[..., :3],
                     pose_rows(jax_anns)[..., :3])


def test_converted_checkpoint_serves_like_jax(tmp_path):
    """``orbax_to_port_checkpoint``, then ``Predictor(checkpoint=...)`` of
    the port against the JAX package's ``Predictor(checkpoint=...)`` on the
    same image."""
    dst = orbax_to_port_checkpoint(FIXTURE, str(tmp_path / 'fixture'))
    image = fixture_image()
    results = {}
    for name, decoders, cli, configure, build in (
            ('jax', jax_decoder_module.factory.DECODERS,
             jax_decoder_module.factory.cli,
             jax_decoder_module.factory.configure,
             lambda: JaxPredictor(checkpoint=FIXTURE)),
            ('port', (port_decoder_module.CifCaf,
                      port_decoder_module.CifCafDense),
             port_decoder_module.cli, port_decoder_module.configure,
             lambda: Predictor(checkpoint=dst, device='cpu'))):
        parser = argparse.ArgumentParser()
        with restored_statics(*decoders):
            cli(parser)
            configure(parser.parse_args(list(FLAGS)))
            predictor = build()
            predictor.long_edge = LONG_EDGE
            predictor.preprocess = predictor._build_preprocess()
            with jax_f32():
                results[name] = predictor.numpy_image(image)[0]
    assert isinstance(predictor.model.base_net, basenetworks.Resnet)
    assert len(results['jax']) == 1
    assert_pose_gate(pose_rows(results['port'])[..., :3],
                     pose_rows(results['jax'])[..., :3])
