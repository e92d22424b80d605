"""Every backbone family of the port against the flax models of the JAX
package (``openpifpaf_tpu/models/basenetworks.py``).

Flax variables (the tree of the flax init, from ``jax.eval_shape``, with
values drawn from a numpy seed: kernels N(0, 1/fan_in), norm scales and
variances in [0.5, 1.5], biases and means N(0, 0.1), so that no layer is
an identity) go through ``convert_jax.state_dict_from_jax``; both models
then see the same NHWC image. Tolerance: 1e-4 of the largest value of each
output (float32 convolutions in two frameworks; the JAX side runs at
float32 matmul precision). In train mode the BatchNorm statistics that the
port commits (``commit_batch_stats``) must equal flax's updated
``batch_stats`` to the same tolerance of the largest statistic.

The registry test builds no weights: ``jax.eval_shape`` of each flax
backbone's init goes through the bridge against the port's ``state_dict``
on the meta device.
"""

import functools
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
from openpifpaf_tpu.models import basenetworks as jax_base
from openpifpaf_tpu.models import factory as jax_factory
from openpifpaf_tpu.models.heads import CompositeField4 as JaxCompositeField4
from openpifpaf_tpu.models.shell import Shell as JaxShell, \
    assign_strides as jax_assign_strides
from openpifpaf_tpu_torch import datasets
from openpifpaf_tpu_torch.models import basenetworks, convert_jax
from openpifpaf_tpu_torch.models import factory as port_factory
from openpifpaf_tpu_torch.plugins.coco.constants import cocokp_head_metas
from openpifpaf_tpu_torch.predictor import Predictor
from openpifpaf_tpu_torch.training import checkpoint

from torch_port_helpers import NARROW, jax_f32, one_torch_thread, \
    randomize_variables, write_synthetic_coco

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RTOL_OF_MAX = 1e-4


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    one_torch_thread()


def _as_shell_variables(variables):
    return {'params': {'base_net': variables['params']},
            'batch_stats': {'base_net': variables.get('batch_stats', {})}}


def _load_backbone(net, variables):
    """The bridged flax backbone variables into the bare port backbone,
    strictly."""
    state = convert_jax.state_dict_from_jax(_as_shell_variables(variables))
    net.load_state_dict({k[len('base_net.'):]: v for k, v in state.items()},
                        strict=True)
    return net


def _assert_close(ours, ref, what):
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, what
    scale = float(np.abs(ref).max())
    assert scale > 0.0, what
    np.testing.assert_allclose(ours, ref, atol=RTOL_OF_MAX * scale, rtol=0,
                               err_msg=what)


def _seeded_variables(jax_net, image_hw, seed):
    """The flax init's variables of ``jax_net``, values from ``seed``."""
    shapes = jax.eval_shape(lambda: jax_net.init(
        jax.random.PRNGKey(0), jnp.zeros((1,) + image_hw + (3,)),
        train=True))
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == 'kernel':
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name in ('scale', 'var'):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        assert name in ('bias', 'mean'), name
        return (0.1 * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _compare_backbone(jax_net, port_net, image_hw, seed, train):
    variables = _seeded_variables(jax_net, image_hw, seed)
    image = np.random.RandomState(seed + 1).randn(2, *image_hw, 3).astype(
        np.float32)
    with jax_f32():
        if train:
            ref, updated = jax.jit(functools.partial(
                jax_net.apply, train=True, mutable=['batch_stats']))(
                    variables, jnp.asarray(image))
        else:
            ref = jax.jit(functools.partial(jax_net.apply, train=False))(
                variables, jnp.asarray(image))
    _load_backbone(port_net, variables)
    x = torch.from_numpy(image).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        out = port_net(x, train)
    assert port_net.stride == jax_net.stride
    assert port_net.out_features == jax_net.out_features == out.shape[1]
    assert float(np.asarray(ref).std()) > 1e-3  # not constant
    _assert_close(out.permute(0, 2, 3, 1).numpy(), ref, 'features')

    n_bn = sum(isinstance(m, basenetworks.BatchNorm)
               for m in port_net.modules())
    if not train:
        return
    assert basenetworks.commit_batch_stats(port_net) == n_bn
    if not n_bn:
        assert 'batch_stats' not in updated or not updated['batch_stats']
        return
    committed = convert_jax.state_dict_from_jax(_as_shell_variables(
        {'params': variables['params'],
         'batch_stats': updated['batch_stats']}))
    state = port_net.state_dict()
    for name, value in committed.items():
        if name.endswith(('running_mean', 'running_var')):
            _assert_close(state[name[len('base_net.'):]].numpy(),
                          value.numpy(), name)


def _resnet_pair(**kwargs):
    return jax_base.Resnet(**kwargs), basenetworks.Resnet(**kwargs)


NARROW_RESNET = dict(layers=(1, 1, 1, 1), base_features=16)
# a BasicBlock's stage 0 has no projection: its width is the stem's 64
NARROW_BASIC = dict(layers=(1, 2, 1, 1), base_features=64, basic_block=True)

#: narrow forms of every family, with each RESNET_OPTIONS switch
CASES = {
    'bottleneck': lambda: _resnet_pair(**NARROW_RESNET),
    'basic': lambda: _resnet_pair(**NARROW_BASIC),
    'resnext': lambda: _resnet_pair(layers=(2, 1, 1, 1), base_features=32,
                                    groups=4, width_per_group=16),
    'pool0_stride': lambda: _resnet_pair(pool0_stride=2, **NARROW_RESNET),
    'pool0_stride_3': lambda: _resnet_pair(pool0_stride=3, **NARROW_BASIC),
    'input_conv_stride': lambda: _resnet_pair(input_conv_stride=1,
                                              **NARROW_RESNET),
    'input_conv2_stride': lambda: _resnet_pair(input_conv2_stride=2,
                                               **NARROW_BASIC),
    'block5_dilation': lambda: _resnet_pair(block5_dilation=2,
                                            **NARROW_RESNET),
    'remove_last_block': lambda: _resnet_pair(remove_last_block=True,
                                              **NARROW_BASIC),
    'mobilenetv2': lambda: (jax_base.MobileNetV2(),
                            basenetworks.MobileNetV2()),
    'mobilenetv3large': lambda: (jax_base.MobileNetV3(variant='large'),
                                 basenetworks.MobileNetV3('large')),
    'mobilenetv3small': lambda: (jax_base.MobileNetV3(variant='small'),
                                 basenetworks.MobileNetV3('small')),
    'squeezenet': lambda: (jax_base.SqueezeNet(), basenetworks.SqueezeNet()),
    'shufflenet_group_norm': lambda: (
        jax_base.ShuffleNetV2K(stages_repeats=NARROW[0],
                               stages_out_channels=NARROW[1], norm='group'),
        basenetworks.ShuffleNetV2K(*NARROW, norm='group')),
    # 29 groups above 100 features that 32 does not divide, 32 where it does
    'shufflenet_group_norm_29_32': lambda: (
        jax_base.ShuffleNetV2K(stages_repeats=[1, 1, 1],
                               stages_out_channels=[8, 232, 464, 128, 256],
                               norm='group'),
        basenetworks.ShuffleNetV2K([1, 1, 1], [8, 232, 464, 128, 256],
                                   norm='group')),
    'shufflenet_instance_norm': lambda: (
        jax_base.ShuffleNetV2K(stages_repeats=NARROW[0],
                               stages_out_channels=NARROW[1],
                               norm='instance'),
        basenetworks.ShuffleNetV2K(*NARROW, norm='instance')),
    'shufflenet_kernel3': lambda: (
        jax_base.ShuffleNetV2K(stages_repeats=NARROW[0],
                               stages_out_channels=NARROW[1], kernel=3),
        basenetworks.ShuffleNetV2K(*NARROW, kernel=3)),
}
# MobileNetV2 has stride 32: at 33 px its train-mode BatchNorms would
# normalise over 2x2 maps
IMAGE_HW = {'mobilenetv2': (65, 97), 'mobilenetv3large': (33, 33),
            'mobilenetv3small': (33, 33), 'squeezenet': (33, 49)}


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
@pytest.mark.parametrize('case', sorted(CASES))
def test_backbone_matches_flax(case, train):
    jax_net, port_net = CASES[case]()
    seed = sorted(CASES).index(case)
    _compare_backbone(jax_net, port_net, IMAGE_HW.get(case, (49, 65)),
                      seed, train)


def test_group_norm_is_flax_group_norm():
    """flax's epsilon, 1e-6: on activations of a small spread torch's
    default (1e-5) gives other values, and the port gives flax's."""
    import flax.linen as nn
    rng = np.random.RandomState(0)
    x = (0.01 + 3e-3 * rng.randn(2, 5, 7, 64)).astype(np.float32)
    module = nn.GroupNorm(num_groups=4)
    variables = randomize_variables(
        module.init(jax.random.PRNGKey(0), jnp.asarray(x)), 0)
    ref = np.asarray(module.apply(variables, jnp.asarray(x)))
    norm = basenetworks.GroupNorm(4, 64)
    assert norm.eps == 1e-6
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(np.asarray(
            variables['params']['scale'])))
        norm.bias.copy_(torch.from_numpy(np.asarray(
            variables['params']['bias'])))
        nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
        out = norm(nchw).permute(0, 2, 3, 1).numpy()
        torch_default = torch.nn.functional.group_norm(
            nchw, 4, norm.weight, norm.bias).permute(0, 2, 3, 1).numpy()
    _assert_close(out, ref, 'group norm')
    assert np.abs(torch_default - ref).max() > 0.1 * np.abs(ref).max()


def _zeros_like_shapes(tree):
    """Broadcast zero arrays of a ``jax.eval_shape`` tree (no memory)."""
    return jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), tree)


#: the entries of ``openpifpaf_tpu/models/factory.py`` and the
#: ``cifar10net`` that both packages' cifar10 plugins add
REGISTRY = set(jax_factory.BASE_FACTORIES)


@pytest.mark.parametrize('name', sorted(REGISTRY))
def test_registry_entry_bridges_at_full_width(name):
    """Every ``BASE_FACTORIES`` entry: the flax init's names and shapes
    through the bridge are the port's ``state_dict``, strict both ways,
    with equal ``stride`` and ``out_features``."""
    datasets.datamodules()  # the plugins register their backbones
    assert set(port_factory.BASE_FACTORIES) == REGISTRY
    jax_net = jax_factory.BASE_FACTORIES[name]()
    shapes = jax.eval_shape(lambda: jax_net.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 65, 65, 3)), train=True))
    bridged = convert_jax.state_dict_from_jax(_as_shell_variables(
        _zeros_like_shapes(shapes)))
    with torch.device('meta'):
        port_net = port_factory.BASE_FACTORIES[name]()
    ours = {f'base_net.{k}': tuple(v.shape)
            for k, v in port_net.state_dict().items()}
    assert ours == {k: tuple(v.shape) for k, v in bridged.items()}
    assert port_net.stride == jax_net.stride
    assert port_net.out_features == jax_net.out_features


def test_full_width_resnet50_fields_match_flax():
    """resnet50 with the cocokp heads at full width, as the JAX defaults
    build it (stride 16, 2048 features), through ``Factory``."""
    metas = openpifpaf_tpu.datasets.factory('cocokp').head_metas
    base = jax_factory.BASE_FACTORIES['resnet50']()
    jax_assign_strides(metas, base.stride)
    model = JaxShell(base_net=base, head_nets=tuple(
        JaxCompositeField4(meta=m) for m in metas))
    variables = _seeded_variables(model, (33, 33), seed=3)
    image = np.random.RandomState(4).randn(1, 49, 65, 3).astype(np.float32)
    with jax_f32():
        ref = jax.jit(functools.partial(model.apply, train=False))(
            variables, jnp.asarray(image))
    port = port_factory.Factory('resnet50').from_scratch(cocokp_head_metas())
    assert isinstance(port.base_net, basenetworks.Resnet)
    assert (port.base_net.stride, port.base_net.out_features) == (16, 2048)
    convert_jax.load_jax_variables(port, variables)
    with torch.no_grad():
        out = port(torch.from_numpy(image))
    for o, r in zip(out, ref):
        _assert_close(o.numpy(), r, 'fields')


@pytest.mark.parametrize('upsample', [2, 3])
def test_upsampled_composite_field4_matches_flax(upsample):
    """The heads with ``upsample_stride`` (``--cocokp-upsample``): the
    PixelShuffle and the symmetric crop, on a narrow ShuffleNetV2K."""
    metas = openpifpaf_tpu.datasets.factory('cocokp').head_metas
    for meta in metas:
        meta.upsample_stride = upsample
    base = jax_base.ShuffleNetV2K(stages_repeats=NARROW[0],
                                  stages_out_channels=NARROW[1])
    jax_assign_strides(metas, base.stride)
    model = JaxShell(base_net=base, head_nets=tuple(
        JaxCompositeField4(meta=m) for m in metas))
    variables = _seeded_variables(model, (33, 33), seed=5)
    image = np.random.RandomState(6).randn(2, 49, 65, 3).astype(np.float32)
    with jax_f32():
        ref = jax.jit(functools.partial(model.apply, train=False))(
            variables, jnp.asarray(image))
    port = port_factory.Factory(upsample_stride=upsample).from_scratch(
        cocokp_head_metas(), base_net=basenetworks.ShuffleNetV2K(*NARROW))
    assert [m.upsample_stride for m in port.head_metas] == [upsample] * 2
    convert_jax.load_jax_variables(port, variables)
    with torch.no_grad():
        out = port(torch.from_numpy(image))
    for o, r in zip(out, ref):
        assert o.shape[-2:] == (4 * upsample - (upsample - 1),
                                5 * upsample - (upsample - 1))
        _assert_close(o.numpy(), r, 'upsampled fields')


def test_bridge_names_a_missing_resnet_block_layer():
    jax_net, _ = _resnet_pair(**NARROW_RESNET)
    variables = _seeded_variables(jax_net, (33, 33), seed=0)
    params = dict(variables['params'])
    block = dict(params['Bottleneck_1'])
    del block['ConvNormAct_1']
    params['Bottleneck_1'] = block
    with pytest.raises(KeyError, match='Bottleneck_1'):
        convert_jax.state_dict_from_jax(_as_shell_variables(
            {'params': params, 'batch_stats': variables['batch_stats']}))


@pytest.mark.parametrize('norm,halves,engine', [
    ('batch', 128, 'halves'), ('group', 128, 'flax'),
    ('instance', 128, 'flax'), ('batch', 64, 'flax')])
def test_auto_engine_folds_only_batch_norm_shufflenets(norm, halves, engine):
    """``'auto'`` folds a BatchNorm ShuffleNetV2K with 128-aligned halves
    and serves anything else on the module graph, as JAX falls back when
    its fold fails; an explicit engine on a backbone that does not fold
    raises."""
    base = basenetworks.ShuffleNetV2K(
        [1, 1, 1], [8, 2 * halves, 4 * halves, 8 * halves, 8 * halves],
        norm=norm)
    model = port_factory.Factory().from_scratch(cocokp_head_metas(),
                                                base_net=base)
    served = Predictor(model=model, device='cpu')
    assert (served._backbone is None) == (engine == 'flax')
    if norm != 'batch':
        with pytest.raises(ValueError, match='cannot fold'):
            Predictor(model=model, device='cpu', backbone_engine='folded')


def test_auto_engine_serves_a_resnet_on_the_module_graph():
    model = port_factory.Factory().from_scratch(
        cocokp_head_metas(), base_net=basenetworks.Resnet(**NARROW_RESNET))
    assert Predictor(model=model, device='cpu')._backbone is None
    with pytest.raises(ValueError, match='cannot fold'):
        Predictor(model=model, device='cpu', backbone_engine='pallas')


@pytest.fixture(scope='module')
def coco(tmp_path_factory):
    return write_synthetic_coco(str(tmp_path_factory.mktemp('coco')),
                                n_images=4, image_hw=(97, 129), seed=1)


@pytest.mark.parametrize('flags,options', [
    (['--basenet', 'resnet18', '--resnet-remove-last-block',
      '--resnet-pool0-stride', '2'],
     ('resnet', {'remove_last_block': True, 'pool0_stride': 2})),
    (['--basenet', 'squeezenet'], None),
    (['--basenet', 'mobilenetv3small'], None),
    (['--basenet', 'shufflenetv2k16', '--shufflenetv2k-group-norm'],
     ('shufflenetv2k', {'norm': 'group'})),
], ids=['resnet18', 'squeezenet', 'mobilenetv3small', 'shufflenetv2k16'])
def test_train_cli_trains_and_serves_other_backbones(coco, tmp_path, flags,
                                                     options):
    """``train --basenet`` with the backbone flags on the CPU: finite
    losses, a checkpoint that records the options, and ``load_shell`` and
    ``Predictor(checkpoint=...)`` rebuilding that backbone from it."""
    ann_file, image_dir = coco
    out = str(tmp_path / 'model')
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    done = subprocess.run(
        [sys.executable, '-m', 'openpifpaf_tpu_torch.train', *flags,
         '--dataset', 'cocokp', '--cocokp-train-annotations', ann_file,
         '--cocokp-val-annotations', ann_file,
         '--cocokp-train-image-dir', image_dir,
         '--cocokp-val-image-dir', image_dir, '--cocokp-square-edge', '97',
         '--batch-size', '2', '--epochs', '1', '--train-batches', '1',
         '--val-batches', '1', '--device', 'cpu', '--output', out],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    with open(out + '.log') as f:
        losses = [json.loads(line)['loss'] for line in f
                  if json.loads(line).get('type') == 'train']
    assert len(losses) == 1 and np.isfinite(losses[0])
    model, meta = checkpoint.load_shell(out)
    assert meta['base_name'] == flags[1]
    reference = port_factory.BASE_FACTORIES[flags[1]]
    if options is not None:
        family, values = options
        for k, v in values.items():
            assert meta['backbone_options'][family][k] == v
            assert getattr(model.base_net, k) == v
        assert port_factory.SHUFFLENETV2K_OPTIONS['norm'] == 'batch'
        assert not port_factory.RESNET_OPTIONS['remove_last_block']
    assert type(model.base_net) is type(reference())
    image = np.random.RandomState(0).randint(0, 256, (97, 129, 3),
                                             dtype=np.uint8)
    predictor = Predictor(checkpoint=out, device='cpu')
    predictor.fields_batch(predictor.preprocess(
        __import__('PIL.Image').Image.fromarray(image), [], {})[0][None])
    assert predictor.model.base_net.stride == model.base_net.stride
