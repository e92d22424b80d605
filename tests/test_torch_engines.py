"""Serving backbone engines of the PyTorch port against the JAX package.

The BN fold, the folded forward, and the plain versions of the three CUDA
kernels (depthwise conv, fused block, branch2) are held against the JAX
functions they replace, on the same numpy inputs; where the JAX function
reaches a Pallas kernel it runs in interpret mode, as the JAX package's own
tests run it. On these CPU tensors the kernels' wrappers run their plain
versions and launch nothing.

Tolerances: the fold is the same float64 arithmetic on both sides (atol
1e-6); forwards through float32 convolutions in two frameworks, atol/rtol
2e-5 for a whole backbone and 1e-5 for one kernel; bfloat16 engines against
the port's own float32 fold (not against JAX, whose depthwise kernel sums in
bfloat16), max abs error within 5% of the largest feature.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpifpaf_tpu.models import block_pallas as jax_bp
from openpifpaf_tpu.models import dw_pallas as jax_dw
from openpifpaf_tpu.models import fused_inference as jax_fi
from openpifpaf_tpu.models import shuffle_pallas as jax_sp
from openpifpaf_tpu.models.basenetworks import \
    ShuffleNetV2K as JaxShuffleNetV2K
from openpifpaf_tpu_torch.models import basenetworks, block_cuda, \
    convert_jax, dw_cuda, shuffle_cuda
from openpifpaf_tpu_torch.models import fused_inference as fi

from torch_port_helpers import backbone_kernel_inputs, jax_f32, \
    one_torch_thread

TINY = ([2, 2, 2], [8, 12, 16, 20, 24])
NET_KWARGS = [
    {},
    {'input_conv2_stride': 2, 'input_conv2_outchannels': 10},
    {'stage4_dilation': 2},
    {'conv5_as_stage': True},
    {'non_linearity': 'leaky_relu'},
]


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    one_torch_thread()


@pytest.fixture(autouse=True)
def _f32_matmuls():
    with jax_f32():
        yield


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))
                            ).contiguous(memory_format=torch.channels_last)


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _nets(repeats, channels, perturb=True, **kwargs):
    """A flax ShuffleNetV2K with random weights (BatchNorm statistics
    perturbed as in ``tests/test_fused_inference.py``) and the port's
    backbone with the same weights, through the strict bridge."""
    net = JaxShuffleNetV2K(stages_repeats=repeats,
                           stages_out_channels=channels, **kwargs)
    variables = net.init(jax.random.PRNGKey(0), jnp.zeros((1, 33, 49, 3)),
                         train=False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    if perturb:
        rng = np.random.RandomState(1)

        def leaf(path, a):
            name = '/'.join(str(p.key) for p in path)
            if 'mean' in name:
                return (rng.randn(*a.shape) * 0.3).astype(a.dtype)
            if 'var' in name:
                return (1.0 + 0.5 * rng.rand(*a.shape)).astype(a.dtype)
            return a

        variables['batch_stats'] = jax.tree_util.tree_map_with_path(
            leaf, variables['batch_stats'])
    state = convert_jax.state_dict_from_jax(
        {'params': {'base_net': variables['params']},
         'batch_stats': {'base_net': variables['batch_stats']}})
    port = basenetworks.ShuffleNetV2K(repeats, channels, **kwargs)
    port.load_state_dict({k[len('base_net.'):]: v for k, v in state.items()},
                         strict=True)
    return net, variables, port.eval()


def _jax_folded(net, variables):
    return jax_fi.fold_shufflenet(net, variables['params'],
                                  variables['batch_stats'])


@pytest.mark.parametrize('net_kwargs', NET_KWARGS)
def test_fold_matches_jax(net_kwargs):
    net, variables, port = _nets(*TINY, **net_kwargs)
    ref = _jax_folded(net, variables)
    out = fi.fold_shufflenet(port)

    def convs(folded, block_type):
        for op in folded.stem + folded.blocks + folded.conv5:
            yield from (op.convs if isinstance(op, block_type) else [op])

    pairs = list(zip(convs(out, fi.FoldedBlock),
                     convs(ref, jax_fi.FoldedBlock), strict=True))
    assert len(pairs) > 20
    for o, r in pairs:
        np.testing.assert_allclose(
            o.weight.numpy(), np.asarray(r.kernel).transpose(3, 2, 0, 1),
            atol=1e-6, rtol=0)
        np.testing.assert_allclose(o.bias.numpy(), np.asarray(r.bias),
                                   atol=1e-6, rtol=0)
        assert (o.stride, o.groups, o.dilation, o.act, o.non_linearity) == \
            (r.stride, r.groups, r.dilation, r.act, r.non_linearity)


@pytest.mark.parametrize('net_kwargs', NET_KWARGS)
def test_folded_forward_matches_flax(net_kwargs):
    net, variables, port = _nets(*TINY, **net_kwargs)
    x = np.random.RandomState(0).randn(2, 33, 49, 3).astype(np.float32)
    ref = np.asarray(net.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        out = fi.fold_shufflenet(port)(_nchw(x))
    assert out.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(_nhwc(out), ref, atol=2e-5, rtol=2e-5)


def test_fold_raises_on_a_backbone_that_does_not_fold():
    with pytest.raises(ValueError, match='only a ShuffleNetV2K'):
        fi.fold_shufflenet(torch.nn.Conv2d(3, 8, 3))
    with pytest.raises(ValueError, match='only a ShuffleNetV2K'):
        fi.build_fused_backbone(torch.nn.Identity())


def _dw_inputs(rng, n, h, w, c, k):
    x = rng.randn(n, h, w, c).astype(np.float32)
    kernel = (0.1 * rng.randn(k, k, 1, c)).astype(np.float32)
    bias = (0.01 * rng.randn(c)).astype(np.float32)
    return x, kernel, bias


def _port_dw(x, kernel, bias, **kwargs):
    before = dw_cuda.LAUNCHES
    args = (_nchw(x), torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()),
            torch.from_numpy(bias))
    out = dw_cuda.depthwise_conv(*args, **kwargs)
    assert dw_cuda.LAUNCHES == before  # a CPU tensor takes the plain version
    torch.testing.assert_close(out, dw_cuda.depthwise_conv_plain(
        *args, **kwargs), rtol=0, atol=0)
    return _nhwc(out)


@pytest.mark.parametrize('h,w,c,k,d', [
    (17, 23, 87, 5, 1),    # the shapes of tests/test_dw_pallas.py
    (33, 40, 174, 5, 1),
    (9, 11, 348, 5, 2),
    (16, 16, 64, 3, 1),
])
def test_depthwise_plain_matches_dw_pallas(h, w, c, k, d):
    x, kernel, bias = _dw_inputs(np.random.RandomState(0), 2, h, w, c, k)
    ref = jax_dw.depthwise_conv(jnp.asarray(x), jnp.asarray(kernel),
                                jnp.asarray(bias), dilation=d, act=True,
                                interpret=True)
    out = _port_dw(x, kernel, bias, dilation=d, act=True)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize('act,leaky', [(False, False), (True, True)])
def test_depthwise_plain_no_act_and_leaky(act, leaky):
    x, kernel, bias = _dw_inputs(np.random.RandomState(1), 1, 12, 15, 32, 5)
    ref = jax_dw.depthwise_conv(jnp.asarray(x), jnp.asarray(kernel),
                                jnp.asarray(bias), act=act, leaky=leaky,
                                interpret=True)
    out = _port_dw(x, kernel, bias, act=act, leaky=leaky)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_dwpallas_mode_routes_only_stride1_depthwise(monkeypatch):
    """``fused_inference.py:49-51``'s routing: stride-1 depthwise convs go
    to the kernel's wrapper, a 1x1 or a strided depthwise conv does not."""
    calls = []
    wrapped = dw_cuda.depthwise_conv
    monkeypatch.setattr(dw_cuda, 'depthwise_conv',
                        lambda *a, **kw: calls.append(1) or wrapped(*a, **kw))
    rng = np.random.RandomState(2)
    c = 24
    x = _nchw(rng.randn(1, 10, 13, c).astype(np.float32))

    def conv(shape, **kwargs):
        return fi.FoldedConv(
            weight=torch.from_numpy(0.1 * rng.randn(*shape).astype(
                np.float32)),
            bias=torch.from_numpy(0.01 * rng.randn(c).astype(np.float32)),
            **kwargs)

    for routed, op in ((True, conv((c, 1, 5, 5), groups=c, act=False)),
                       (False, conv((c, c, 1, 1))),
                       (False, conv((c, 1, 5, 5), groups=c, stride=2))):
        calls.clear()
        out = dataclasses.replace(op, mode='dwpallas')(x)
        assert len(calls) == int(routed)
        torch.testing.assert_close(out, op(x), atol=1e-5, rtol=1e-5)


def _jax_block(rng, cb, k=5, dilation=1, leaky=False):
    """A BN-folded non-first block with random weights, as
    ``tests/test_shuffle_pallas.py`` makes it."""
    def conv(kk, groups=1, act=True):
        cin = 1 if groups > 1 else cb
        return jax_fi.FoldedConv(
            kernel=jnp.asarray(rng.randn(kk, kk, cin, cb).astype(
                np.float32) * 0.2),
            bias=jnp.asarray(rng.randn(cb).astype(np.float32) * 0.1),
            groups=groups, dilation=dilation, act=act,
            non_linearity='leaky_relu' if leaky else 'relu')
    return jax_fi.FoldedBlock(first_in_stage=False, convs=[
        conv(1), conv(k, groups=cb, act=False), conv(1)])


def _port_weights(block):
    """The port's BlockWeights of a JAX FoldedBlock."""
    convs = [fi.FoldedConv(
        weight=torch.from_numpy(np.asarray(c.kernel).transpose(
            3, 2, 0, 1).copy()),
        bias=torch.from_numpy(np.array(c.bias)), groups=c.groups,
        dilation=c.dilation, act=c.act, non_linearity=c.non_linearity)
        for c in block.convs]
    return shuffle_cuda.block_weights_from_folded(
        fi.FoldedBlock(first_in_stage=False, convs=convs))


BLOCK_CASES = [  # the cases of tests/test_shuffle_pallas.py
    ((2, 21, 17, 24), 12, 5, 1, 8, False),     # ragged last tile
    ((1, 16, 16, 8), 4, 5, 1, 16, False),      # single tile
    ((1, 11, 9, 12), 6, 3, 1, 4, False),       # k=3
    ((1, 15, 13, 12), 6, 5, 2, 8, False),      # dilation 2
    ((1, 12, 10, 16), 8, 5, 1, 8, True),       # leaky relu
]


@pytest.mark.parametrize('shape,cb,k,dilation,tile_rows,leaky', BLOCK_CASES)
def test_fused_block_plain_matches_shuffle_pallas(shape, cb, k, dilation,
                                                  tile_rows, leaky):
    rng = np.random.RandomState(0)
    block = _jax_block(rng, cb, k=k, dilation=dilation, leaky=leaky)
    # the JAX kernel's one-hot interleave needs x1 >= 0 (post-ReLU input)
    x = np.maximum(rng.randn(*shape).astype(np.float32), 0)
    halo = (k - 1) // 2 * dilation
    height, width = shape[1:3]
    outa, outb = jax_sp.fused_block(
        jax_sp.pad_half(jnp.asarray(x[..., :cb]), halo),
        jax_sp.pad_half(jnp.asarray(x[..., cb:]), halo),
        jax_sp.block_weights_from_folded(block), height=height, width=width,
        k=k, dilation=dilation, tile_rows=tile_rows, leaky=leaky,
        interpret=True)
    ref = np.concatenate(
        [np.asarray(jax_sp.unpad_half(o, halo, height, width, cb))
         for o in (outa, outb)], axis=-1)

    weights = _port_weights(block)
    before = shuffle_cuda.LAUNCHES
    out = shuffle_cuda.fused_block(_nchw(x), weights, k=k,
                                   dilation=dilation, leaky=leaky)
    assert shuffle_cuda.LAUNCHES == before
    assert out.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(_nhwc(out), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize('shape,cb,k,dilation,r_tile,leaky', BLOCK_CASES)
def test_branch2_plain_and_segment_match_block_pallas(shape, cb, k, dilation,
                                                      r_tile, leaky):
    rng = np.random.RandomState(0)
    block = _jax_block(rng, cb, k=k, dilation=dilation, leaky=leaky)
    x = np.maximum(rng.randn(1, *shape[1:]).astype(np.float32), 0)
    h, w = shape[1:3]
    c2p = jax_bp._round_up(2 * cb, 128)
    cm = jax_bp._round_up(cb, 128)
    jax_weights = jax_bp.branch2_weights_from_folded(block, c2p, cm)
    xp = jax_bp.pad_activation(jnp.asarray(x[0]), h=h, w=w, k=k, d=dilation,
                               r_tile=r_tile, c2p=c2p)
    ref_y3 = np.asarray(jax_bp.branch2_apply(
        xp, jax_weights, h=h, w=w, k=k, d=dilation, r_tile=r_tile,
        interpret=True))[:h, :w, :cb]
    ref = np.asarray(jax_bp.run_segment(
        jnp.asarray(x[0]), [jax_weights], k=k, d=dilation, r_tile=r_tile,
        interpret=True))

    weights = _port_weights(block)
    before = block_cuda.LAUNCHES
    y3 = block_cuda.branch2_apply(_nchw(x), weights, k=k, dilation=dilation,
                                  leaky=leaky)
    out = block_cuda.run_segment(_nchw(x), [weights], k=k,
                                 dilation=dilation, leaky=leaky)
    assert block_cuda.LAUNCHES == before
    np.testing.assert_allclose(_nhwc(y3)[0], ref_y3, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_nhwc(out)[0], ref, atol=1e-5, rtol=1e-5)


def test_run_segment_two_block_chain():
    rng = np.random.RandomState(1)
    cb, k = 8, 5
    blocks = [_jax_block(rng, cb, k=k) for _ in range(2)]
    x = np.maximum(rng.randn(1, 19, 14, 2 * cb).astype(np.float32), 0)
    c2p = jax_bp._round_up(2 * cb, 128)
    cm = jax_bp._round_up(cb, 128)
    ref = np.asarray(jax_bp.run_segment(
        jnp.asarray(x[0]),
        [jax_bp.branch2_weights_from_folded(b, c2p, cm) for b in blocks],
        k=k, d=1, r_tile=8, interpret=True))
    out = block_cuda.run_segment(_nchw(x), [_port_weights(b) for b in blocks],
                                 k=k)
    np.testing.assert_allclose(_nhwc(out)[0], ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize('engine', ['pallas', 'mosaic'])
def test_kernel_forwards_match_jax(engine):
    """The port's ``build_pallas_forward`` / ``build_mosaic_forward``
    against JAX's on the tiny net of ``tests/test_shuffle_pallas.py``."""
    net, variables, port = _nets([2, 3, 2], TINY[1], perturb=False)
    x = np.random.RandomState(1).randn(1, 33, 49, 3).astype(np.float32)
    folded = _jax_folded(net, variables)
    if engine == 'pallas':
        forward = jax_fi.build_pallas_forward(
            net, folded, dtype=jnp.float32, tile_rows=8, interpret=True)
        port_forward = fi.build_pallas_forward(fi.fold_shufflenet(port),
                                               dtype=torch.float32)
    else:
        forward = jax_bp.build_mosaic_forward(
            net, folded, dtype=jnp.float32, r_tile=8, interpret=True)
        port_forward = block_cuda.build_mosaic_forward(
            fi.fold_shufflenet(port), dtype=torch.float32)
    ref = np.asarray(jax.jit(forward)(jnp.asarray(x)))
    with torch.no_grad():
        out = port_forward(_nchw(x))
    np.testing.assert_allclose(_nhwc(out), ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize('engine', ['folded', 'dwpallas', 'pallas',
                                    'mosaic'])
def test_bf16_engines_match_port_float32(engine):
    _, _, port = _nets(*TINY, stage4_dilation=2)
    folded = fi.fold_shufflenet(port)
    x = _nchw(np.random.RandomState(3).randn(2, 33, 49, 3).astype(
        np.float32))
    forward = {
        'folded': lambda f: f.cast(torch.bfloat16),
        'dwpallas': lambda f: f.cast(torch.bfloat16).with_mode('dwpallas'),
        'pallas': lambda f: fi.build_pallas_forward(f, dtype=torch.bfloat16),
        'mosaic': lambda f: block_cuda.build_mosaic_forward(
            f, dtype=torch.bfloat16),
    }[engine](folded)
    with torch.no_grad():
        ref = folded(x)
        out = forward(x.to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    err = float((out.float() - ref).abs().max())
    assert err <= 0.05 * float(ref.abs().max()), err


@pytest.mark.parametrize('name,call,counter', [
    ('depthwise_conv', dw_cuda.depthwise_conv, dw_cuda),
    ('shuffle_block', shuffle_cuda.fused_block, shuffle_cuda),
    ('shuffle_branch2', block_cuda.branch2_apply, block_cuda),
])
def test_kernel_wrappers_take_no_other_device(name, call, counter):
    """Only a CPU tensor takes the plain version: on any other device a
    wrapper launches its kernel or raises, and never falls back."""
    args, kw = backbone_kernel_inputs(name, (1, 16, 9, 11))
    call(*args, **kw)  # CPU: the plain version, no launch
    meta = [a.to('meta') if isinstance(a, torch.Tensor) else
            shuffle_cuda.BlockWeights(*[t.to('meta') for t in a.tensors()])
            for a in args]
    before = counter.LAUNCHES
    with pytest.raises(ValueError, match='CUDA tensor'):
        call(*meta, **kw)
    assert counter.LAUNCHES == before
