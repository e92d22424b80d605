"""Networks of the PyTorch port against the flax models of the JAX package.

The flax variables (random init, with BatchNorm parameters and statistics
randomised from a numpy seed so that no layer is an identity) are bridged
with ``convert_jax.state_dict_from_jax``; both models then see the same
NHWC image. Tolerance: atol 1e-4 on the per-head fields (float32
convolutions in two frameworks; the JAX side runs at float32 matmul
precision).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openpifpaf_tpu
from openpifpaf_tpu.models import basenetworks as jax_base
from openpifpaf_tpu.models import factory as jax_factory
from openpifpaf_tpu.models.heads import CompositeField4 as JaxCompositeField4
from openpifpaf_tpu.models.shell import Shell as JaxShell, \
    assign_strides as jax_assign_strides
from openpifpaf_tpu_torch.models import basenetworks, convert_jax
from openpifpaf_tpu_torch.models.factory import Factory
from openpifpaf_tpu_torch.plugins.coco.constants import cocokp_head_metas

from torch_port_helpers import jax_f32, one_torch_thread

ATOL = 1e-4
NARROW = ([1, 2, 1], [8, 16, 32, 64, 64])


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    one_torch_thread()


def _randomize(variables, seed):
    """BatchNorm scale/var in [0.5, 1.5], biases and means ~ N(0, 0.1)."""
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


def _jax_shell(repeats, channels):
    metas = openpifpaf_tpu.datasets.factory('cocokp').head_metas
    base = jax_base.ShuffleNetV2K(stages_repeats=repeats,
                                  stages_out_channels=channels)
    jax_assign_strides(metas, base.stride)
    return JaxShell(base_net=base, head_nets=tuple(
        JaxCompositeField4(meta=m) for m in metas))


def _compare(jax_model, variables, torch_model, image):
    with jax_f32():
        ref = jax_model.apply(variables, jnp.asarray(image), train=False)
    convert_jax.load_jax_variables(torch_model, variables)
    torch_model.eval()
    with torch.no_grad():
        out = torch_model(torch.from_numpy(image))
    assert len(out) == len(ref) == 2
    for o, r in zip(out, ref):
        assert tuple(o.shape) == r.shape
        assert np.asarray(r)[:, :, 1].std() > 1e-3  # fields are not constant
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize('image_hw', [(65, 97), (81, 81)])
def test_narrow_shufflenet_fields_match_flax(image_hw):
    model = _jax_shell(*NARROW)
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, 65, 65, 3)), train=True)
    variables = _randomize(variables, seed=0)
    image = np.random.RandomState(1).randn(2, *image_hw, 3).astype(
        np.float32)
    torch_model = Factory().from_scratch(
        cocokp_head_metas(), base_net=basenetworks.ShuffleNetV2K(*NARROW))
    _compare(model, variables, torch_model, image)


def test_full_width_k16_fields_match_flax():
    """The package default model: every real parameter name is bridged."""
    model = _jax_shell([4, 8, 4], [24, 348, 696, 1392, 1392])
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, 65, 65, 3)), train=True)
    variables = _randomize(variables, seed=2)
    image = np.random.RandomState(3).randn(1, 65, 65, 3).astype(np.float32)
    torch_model = Factory().from_scratch(cocokp_head_metas())
    assert isinstance(torch_model.base_net, basenetworks.ShuffleNetV2K)
    assert torch_model.base_net.stages_out_channels == \
        jax_factory.BASE_FACTORIES['shufflenetv2k16']().stages_out_channels
    _compare(model, variables, torch_model, image)


def test_bridge_raises_on_leftover_and_missing_names():
    model = _jax_shell(*NARROW)
    variables = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 33, 33, 3)), train=True))
    extra = {'params': dict(variables['params'], extra_head={
        'Conv_0': {'kernel': np.zeros((1, 1, 2, 2), np.float32)}}),
             'batch_stats': variables['batch_stats']}
    with pytest.raises(KeyError, match='no port counterpart'):
        convert_jax.state_dict_from_jax(extra)

    stats = dict(variables['batch_stats'])
    base = dict(stats['base_net'])
    del base['ConvNormAct_1']
    stats['base_net'] = base
    with pytest.raises(KeyError, match='missing'):
        convert_jax.state_dict_from_jax({'params': variables['params'],
                                         'batch_stats': stats})

    wider = Factory().from_scratch(
        cocokp_head_metas(),
        base_net=basenetworks.ShuffleNetV2K([1, 2, 2], NARROW[1]))
    with pytest.raises(RuntimeError, match='Missing key'):
        convert_jax.load_jax_variables(wider, variables)


def test_channel_interleave2_matches_jax():
    rng = np.random.RandomState(0)
    a = rng.randn(2, 3, 4, 5).astype(np.float32)
    b = rng.randn(2, 3, 4, 5).astype(np.float32)
    ref = np.asarray(jax_base.channel_interleave2(
        jnp.asarray(a.transpose(0, 2, 3, 1)),
        jnp.asarray(b.transpose(0, 2, 3, 1))))
    out = basenetworks.channel_interleave2(torch.from_numpy(a),
                                           torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(out.transpose(0, 2, 3, 1), ref)


def test_random_init_is_seeded():
    """The factory's initialisation is a function of its generator."""
    metas = cocokp_head_metas()

    def weights(seed):
        model = Factory().from_scratch(
            metas, generator=torch.Generator().manual_seed(seed),
            base_net=basenetworks.ShuffleNetV2K(*NARROW))
        return model.head_nets[0].conv.weight

    assert torch.equal(weights(0), weights(0))
    assert not torch.equal(weights(0), weights(1))
