"""The PyTorch port on a CUDA device: the hand-written kernels (CifHr,
depthwise conv, fused block, branch2, and the Mosaic lab's interleave,
VALID depthwise and branch2) against their plain versions, the CifHr
impls against each other, the decode under every configuration
against the JAX poses of the golden file and against the CPU, a train
step against the CPU, BatchNorm's running-statistics rule and the bf16
step, the other backbones (resnet50, a group-norm k16) against the CPU,
the engine choice on a group-norm k20, the eval CLI, tracking (the
k16 tracking forward against the CPU, the tracking golden sequence, a
cocokpst train step), the wholebody-133 golden decode, detection (the
CifDet golden decode, the engines under the cocodet head), a
reference-layout k16 pickle served through the fused-block engine, the
golden scene's decoding order drawn (where matplotlib is installed),
the pipelined serving loop with its decode on a side stream, the CifHr
call of an AOTInductor package, and the spatial mesh's shards on the card
(the engines' kernels on haloed shards, the spatial train step).

Every test here needs a GPU (marker ``gpu``) and skips without one. This
file imports neither JAX nor the JAX package, so it runs on a machine that
has only PyTorch; there, skip ``tests/conftest.py`` (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from openpifpaf_tpu_torch import parallel
from openpifpaf_tpu_torch.decoder import CifCaf
from openpifpaf_tpu_torch.lab import kernels as lab_kernels
from openpifpaf_tpu_torch.lab import mosaic_lab
from openpifpaf_tpu_torch.models import basenetworks, block_cuda, dw_cuda, \
    shuffle_cuda
from openpifpaf_tpu_torch.models.factory import Factory
from openpifpaf_tpu_torch.models.shell import assign_strides
from openpifpaf_tpu_torch.ops import cifhr, cifhr_cuda
from openpifpaf_tpu_torch.plugins.coco.constants import cocokp_head_metas
from openpifpaf_tpu_torch.predictor import Predictor

from torch_port_helpers import CIFDET_CONFIGS, CIFDET_GOLDEN, \
    CIFDET_SCENES, CIFDET_STRIDE, assert_det_gate, cifdet_golden_fields
from torch_port_helpers import CONFIGS, GOLDEN, GOLDEN_SPARSE_FLAGS, \
    GOLDEN_STRIDE, TRACKING_GOLDEN, WHOLEBODY_GOLDEN, WHOLEBODY_SEEDS, \
    assert_pose_gate, port_wholebody_metas, \
    assert_tracking_frame, backbone_kernel_inputs, decode_frames, \
    golden_inputs, golden_runs, lab_kernel_inputs, optimizer_args, \
    order_rows, port_decoder, port_narrow_shell, port_tracking_decoder, \
    pose_rows, random_cells, reset_port_track_ids, tracking_golden_fields, \
    write_synthetic_coco

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda:0')


def _check_cifhr(cells, hr_h, hr_w, **kw):
    """The CUDA kernel against its plain version on the card, bit for bit
    (the same operations in the same order, no FMA contraction), with one
    launch counted."""
    before = cifhr_cuda.LAUNCHES
    out = cifhr_cuda.accumulate(*cells, hr_h=hr_h, hr_w=hr_w, **kw)
    assert cifhr_cuda.LAUNCHES == before + 1
    ref = cifhr.accumulate_dense(*cells, hr_h=hr_h, hr_w=hr_w, **kw)
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (cells[0].shape[0], hr_h, hr_w)
    np.testing.assert_array_equal(out.cpu().numpy(), ref.cpu().numpy())
    return ref


@pytest.mark.parametrize('shape,kw', [
    # (n_fields, n_cells, hr_h, hr_w): ragged bands, several cull rounds,
    # the decode's 641px map at both tiers and at wholebody's 133 fields
    ((3, 37, 65, 81), {}),
    ((5, 700, 129, 161), {}),
    ((17, 256, 513, 641), {}),
    ((17, 1024, 513, 641), {}),
    ((133, 256, 513, 641), {}),
    ((3, 32, 65, 81), {'neighbors': 8, 'factor': 0.5}),
    # hr_w = 1, 2 and 3 mod 4
    ((4, 64, 37, 33), {}),
    ((4, 64, 37, 34), {}),
    ((4, 64, 37, 35), {}),
    # two column chunks per band
    ((2, 200, 40, 1500), {}),
])
def test_cuda_kernel_matches_plain(cuda, shape, kw):
    n_fields, n_cells, hr_h, hr_w = shape
    cells = random_cells(n_fields, n_cells, hr_h, hr_w, seed=n_cells,
                         device=cuda)
    ref = _check_cifhr(cells, hr_h, hr_w, **kw)
    assert float(ref.max()) > 0.01


@pytest.mark.parametrize('hr_h,hr_w', [(1, 200), (200, 1), (5, 81)])
def test_cuda_kernel_one_row_one_column_and_short_maps(cuda, hr_h, hr_w):
    """A 1-row and a 1-column map, and one shorter than a band."""
    cells = random_cells(3, 96, hr_h, hr_w, seed=hr_w, device=cuda)
    _check_cifhr(cells, hr_h, hr_w)


def _small_lists(p):
    """Plan ``p`` with a list of one cull round: a CTA whose cells do not
    fit culls each band's cells from global memory and accumulates them in
    rounds."""
    cap = p.threads * cifhr_cuda.CELLS_PER_THREAD
    return dataclasses.replace(p, cap=cap, smem=cifhr_cuda.shared_bytes(cap))


def test_cuda_kernel_dense_cells_in_rounds(cuda):
    """K = 3000 live cells crowded into a few bands: with the plan's lists
    and with small ones (:func:`_small_lists`), the survivors accumulated
    in rounds, still in ascending order (small weights, so that few pixels
    saturate at 1)."""
    x, y, sigma, w = random_cells(2, 3000, 97, 161, seed=3, device=cuda)
    y = 40.0 + (y - y.min()) * (12.0 / float(y.max() - y.min()))
    w = torch.where(w == 0.0, 0.5, w) * 0.01
    ref = _check_cifhr((x, y, sigma, w), 97, 161)
    p = _small_lists(cifhr_cuda.plan(2, 3000, 97, 161))
    out = cifhr_cuda.launch(x, y, sigma, w, p, hr_h=97, hr_w=161)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(out.cpu().numpy(), ref.cpu().numpy())


def test_cuda_kernel_all_weights_zero(cuda):
    x, y, sigma, w = random_cells(3, 128, 65, 81, seed=2, device=cuda)
    out = cifhr_cuda.accumulate(x, y, sigma, torch.zeros_like(w), hr_h=65,
                                hr_w=81)
    torch.cuda.synchronize()
    assert not bool(out.any())


@pytest.mark.parametrize('bands_per_cta', [1, 3])
@pytest.mark.parametrize('groups', [1, 2, 4])
def test_cuda_kernel_every_plan_mode(cuda, groups, bands_per_cta):
    """Row groups and bands per CTA, at a map whose rows are 1 mod 4
    floats, with the plan's list, with a small one and with 3 column
    chunks: the kernel writes every pixel (the map's memory held NaN
    before) and equals the plain version."""
    n_fields, n_cells, hr_h, hr_w = 3, 700, 97, 129
    cells = random_cells(n_fields, n_cells, hr_h, hr_w, seed=groups,
                         device=cuda)
    ref = cifhr.accumulate_dense(*cells, hr_h=hr_h, hr_w=hr_w)
    kw = dict(groups=groups, bands_per_cta=bands_per_cta)
    p = cifhr_cuda.plan(n_fields, n_cells, hr_h, hr_w, **kw)
    chunked = cifhr_cuda.plan(n_fields, n_cells, hr_h, hr_w,
                              max_threads=64 * groups, **kw)
    assert chunked.chunks == 3
    for q in (p, _small_lists(p), chunked):
        # the caching allocator hands the NaN block to the kernel's output
        poison = torch.full((n_fields, hr_h, hr_w), float('nan'), device=cuda)
        del poison
        out = cifhr_cuda.launch(*cells, q, hr_h=hr_h, hr_w=hr_w)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(out.cpu().numpy(), ref.cpu().numpy())


def test_cuda_kernel_refuses_a_bad_plan(cuda):
    cells = random_cells(2, 64, 65, 81, seed=0, device=cuda)
    p = cifhr_cuda.plan(2, 64, 65, 81)
    for bad in (dataclasses.replace(p, smem=p.smem + 4),
                dataclasses.replace(p, threads=32 * p.groups, chunks=1),
                dataclasses.replace(p, cap=p.cap - 1, smem=p.smem - 16),
                dataclasses.replace(p, bands_per_cta=0),
                dataclasses.replace(p, groups=3)):
        with pytest.raises(RuntimeError, match='launch failed'):
            cifhr_cuda.launch(*cells, bad, hr_h=65, hr_w=81)


def test_cuda_kernel_one_device_op_per_call(cuda):
    """A call of the wrapper issues exactly one device op, the kernel (the
    weights are scaled inside it; contiguous cells are not copied)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cells = random_cells(17, 256, 513, 641, seed=1, device=cuda)
    # the first profiler session of a process can miss its launches
    with profile(activities=[ProfilerActivity.CUDA]):
        cifhr_cuda.accumulate(*cells, hr_h=513, hr_w=641)
        torch.cuda.synchronize()
    before = cifhr_cuda.LAUNCHES
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cifhr_cuda.accumulate(*cells, hr_h=513, hr_w=641)
        torch.cuda.synchronize()
    ops = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert cifhr_cuda.LAUNCHES == before + 1
    assert len(ops) == 1 and 'cifhr_band_kernel' in ops[0], ops


class _CifhrProgram(torch.nn.Module):
    def forward(self, x, y, sigma, w):
        return cifhr_cuda.accumulate(x, y, sigma, w, hr_h=513, hr_w=641)


def test_cuda_package_cifhr_call_is_the_kernel(cuda, tmp_path):
    """In an AOTInductor package compiled for the card (``export --format
    savedmodel``'s compile), the CifHr operator's call launches the
    kernel: one counted launch, bit-equal to the plain version."""
    from openpifpaf_tpu_torch import export

    cells = random_cells(17, 256, 513, 641, seed=2, device=cuda)
    with torch.no_grad():
        program = torch.export.export(_CifhrProgram(), tuple(cells))
    path = export.compile_package(program, str(tmp_path / 'cifhr.pt2'))
    package = torch._inductor.aoti_load_package(path)
    before = cifhr_cuda.LAUNCHES
    out = package(*cells)
    torch.cuda.synchronize()
    assert cifhr_cuda.LAUNCHES == before + 1
    ref = cifhr.accumulate_dense(*cells, hr_h=513, hr_w=641)
    np.testing.assert_array_equal(out.cpu().numpy(), ref.cpu().numpy())


def test_cuda_decode_matches_golden_jax_poses(cuda):
    """``CifCaf`` on CUDA tensors gives the JAX poses of the golden file
    (tie-free gate of ``test_adversarial_parity.py``) and escalates the
    40-person scene to the crowd tier through the kernel."""
    golden = np.load(GOLDEN)
    names = ('sparse', 'crowd')
    fields = [torch.from_numpy(np.stack([golden[f'{n}_{head}']
                                         for n in names])).to(cuda)
              for head in ('cif', 'caf')]
    decoder = CifCaf(*assign_strides(cocokp_head_metas(), GOLDEN_STRIDE))
    before = cifhr_cuda.LAUNCHES
    annotations = decoder.batch_decode(fields)
    assert cifhr_cuda.LAUNCHES > before
    assert decoder.last_escalated == [1]
    for name, anns in zip(names, annotations):
        ours = [np.concatenate([a.data[:, 2:3], a.data[:, :2],
                                a.joint_scales[:, None]], axis=1)
                for a in anns]
        assert_pose_gate(ours, list(golden[f'{name}_poses']))


def test_cuda_wholebody_decode_matches_golden_jax_poses(cuda):
    """``CifCaf`` at 133 keypoints on CUDA tensors, CifHr through the
    kernel, gives the JAX poses of ``golden/torch_wholebody_golden.npz``
    (the contested scenes, tie-free gate)."""
    golden = np.load(WHOLEBODY_GOLDEN)
    decoder = CifCaf(*port_wholebody_metas())
    for seed in WHOLEBODY_SEEDS:
        fields = [torch.from_numpy(golden[f'scene{seed}_{head}'][None])
                  .to(cuda) for head in ('cif', 'caf')]
        before = cifhr_cuda.LAUNCHES
        annotations, = decoder.batch_decode(fields)
        assert cifhr_cuda.LAUNCHES > before
        assert all(a.data.shape == (133, 3) for a in annotations)
        assert_pose_gate(pose_rows(annotations),
                         list(golden[f'scene{seed}_poses']))


def test_cuda_cif_hr_pallas_launches_once_and_equals_dense(cuda):
    """``cif_hr(impl='pallas')`` on a CUDA tensor is one kernel launch and
    equals the plain map of ``impl='dense'`` (no launch) bit for bit;
    ``'auto'`` launches the kernel too."""
    cif = torch.from_numpy(np.load(GOLDEN)['sparse_cif']).to(cuda)
    before = cifhr_cuda.LAUNCHES
    pallas = cifhr.cif_hr(cif, GOLDEN_STRIDE, impl='pallas')
    assert cifhr_cuda.LAUNCHES == before + 1
    dense = cifhr.cif_hr(cif, GOLDEN_STRIDE, impl='dense')
    assert cifhr_cuda.LAUNCHES == before + 1
    auto = cifhr.cif_hr(cif, GOLDEN_STRIDE, impl='auto')
    assert cifhr_cuda.LAUNCHES == before + 2
    torch.cuda.synchronize()
    assert float(dense.max()) > 0.5
    np.testing.assert_array_equal(pallas.cpu().numpy(), dense.cpu().numpy())
    np.testing.assert_array_equal(auto.cpu().numpy(), dense.cpu().numpy())


@pytest.mark.parametrize('scene', ['sparse', 'crowd'])
def test_cuda_lazy_cif_hr_matches_dense_lookup(cuda, scene):
    """The lazy CifHr on the card at 4096 points per field (half near the
    cells) against the plain map's lookup there, atol 1e-6."""
    golden = np.load(GOLDEN)
    cif = torch.from_numpy(golden[f'{scene}_cif']).to(cuda)
    cells, hs, ws, _ = cifhr.cif_hr_cells(cif, GOLDEN_STRIDE, n_cells=1024)
    g = torch.Generator(device='cpu').manual_seed(0)
    n = 4096
    x = (torch.rand((17, n), generator=g) * (ws + 6) - 3).to(cuda)
    y = (torch.rand((17, n), generator=g) * (hs + 6) - 3).to(cuda)
    near = torch.randint(0, 64, (17, n // 2), generator=g).to(cuda)
    x[:, :n // 2] = torch.gather(cells['x'], 1, near) + 4 * torch.rand(
        (17, n // 2), generator=g).to(cuda) - 2
    y[:, :n // 2] = torch.gather(cells['y'], 1, near) + 4 * torch.rand(
        (17, n // 2), generator=g).to(cuda) - 2
    before = cifhr_cuda.LAUNCHES
    lazy = cifhr.eval_cells(cells, x, y, hs=hs, ws=ws)
    dense = cifhr.cif_hr(cif, GOLDEN_STRIDE, impl='dense', n_cells=1024)
    assert cifhr_cuda.LAUNCHES == before
    f = torch.arange(17, device=cuda)[:, None].expand(17, n)
    ref = cifhr.cifhr_lookup(dense, f, x, y)
    assert int((ref > 0.1).sum()) > 1000
    np.testing.assert_allclose(lazy.cpu().numpy(), ref.cpu().numpy(),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize('config', ['greedy', 'force_complete'])
def test_cuda_decode_config_equals_cpu(cuda, config):
    """The greedy and the force-complete decode of the weakened golden
    3-person scene on CUDA tensors against the same decode on the CPU:
    the gate, and equal decoding orders with the order recorded."""
    golden = np.load(GOLDEN)
    flags, overrides = CONFIGS[config]
    decoder = port_decoder(GOLDEN_STRIDE, flags + GOLDEN_SPARSE_FLAGS,
                           dict(overrides, export_decoding_order=True))
    out = {}
    for device in (cuda, torch.device('cpu')):
        fields, _ = golden_inputs(golden, 'sparse', config,
                                  f'sparse_{config}', device)
        out[device.type] = decoder.batch_decode(fields)[0]
    assert len(out['cpu']) == 3
    assert_pose_gate(list(pose_rows(out['cuda'])),
                     list(pose_rows(out['cpu'])))
    np.testing.assert_array_equal(order_rows(out['cuda']),
                                  order_rows(out['cpu']))


@pytest.mark.parametrize('run', golden_runs(), ids=lambda r: r[0])
def test_cuda_decode_configs_match_golden(cuda, run):
    """Each decoder configuration on the card gives the golden JAX poses,
    decoding orders and ids, with the CifHr kernel launched only where the
    configuration materialises the map through it."""
    label, scene, config, flags, overrides, key, kernel = run
    golden = np.load(GOLDEN)
    decoder = port_decoder(GOLDEN_STRIDE, flags, overrides)
    fields, initial = golden_inputs(golden, scene, config, key, cuda)
    before = cifhr_cuda.LAUNCHES
    anns = decoder.batch_decode(fields, initial)[0]
    assert (cifhr_cuda.LAUNCHES > before) == kernel
    assert decoder.last_escalated == ([0] if scene == 'crowd' else [])
    assert_pose_gate(list(pose_rows(anns)), list(golden[f'{key}_poses']))
    if f'{key}_order' in golden.files:
        np.testing.assert_array_equal(order_rows(anns),
                                      golden[f'{key}_order'])
    if f'{key}_ids' in golden.files:
        np.testing.assert_array_equal(
            [-1 if a.id_ is None else a.id_ for a in anns],
            golden[f'{key}_ids'])


#: (kernel wrapper, its plain version, its launch counter)
BACKBONE_KERNELS = {
    'depthwise_conv': (dw_cuda.depthwise_conv, dw_cuda.depthwise_conv_plain,
                       dw_cuda),
    'shuffle_block': (shuffle_cuda.fused_block,
                      shuffle_cuda.fused_block_plain, shuffle_cuda),
    'shuffle_branch2': (block_cuda.branch2_apply,
                        shuffle_cuda.branch2_plain, block_cuda),
}


def _check_backbone_kernel(name, shape, dtype, device, **kwargs):
    """The kernel against its plain version, TF32 off: float32 within 1e-5
    (summation order), bfloat16 within one rounding step of the largest
    output."""
    call, plain, counter = BACKBONE_KERNELS[name]
    args, kw = backbone_kernel_inputs(name, shape, dtype=dtype,
                                      device=device, **kwargs)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        before = counter.LAUNCHES
        out = call(*args, **kw)
        assert counter.LAUNCHES == before + 1
        ref = plain(*args, **kw)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert out.shape == ref.shape and out.dtype == dtype
    assert out.is_contiguous(memory_format=torch.channels_last)
    tol = 1e-5 if dtype == torch.float32 else \
        2.0 ** -7 * float(ref.float().abs().max())
    err = float((out.float() - ref.float()).abs().max())
    assert err <= tol, (err, tol)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape,k,dilation,act,leaky', [
    ((2, 40, 13, 17), 5, 1, False, False),     # batch 2, no act (the model)
    ((1, 24, 15, 13), 5, 2, True, True),       # dilation 2, leaky
    ((1, 32, 11, 9), 3, 1, True, False),       # k=3, ReLU
    ((1, 174, 129, 161), 5, 1, False, False),  # k16 stage 2, 513x641 input
    ((1, 348, 65, 81), 5, 1, False, False),    # k16 stage 3
    ((1, 696, 33, 41), 5, 1, False, False),    # k16 stage 4
    # one for each vector width of the plan: odd C (1 channel), C = 174
    # (2), C = 64 on a batch wide enough for 16-byte vectors (4 channels in
    # float32, 8 in bfloat16)
    ((1, 35, 11, 9), 5, 1, True, False),
    ((1, 174, 13, 17), 5, 1, False, False),
    ((8, 64, 64, 80), 5, 1, False, False),
    ((1, 48, 19, 23), 5, 2, False, False),     # halo 4: strips by phase
    ((1, 24, 30, 33), 7, 1, True, False),      # k=7
])
def test_depthwise_kernel_matches_plain(cuda, shape, k, dilation, act, leaky,
                                        dtype):
    _check_backbone_kernel('depthwise_conv', shape, dtype, cuda, k=k,
                           dilation=dilation, act=act, leaky=leaky)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('name', ['shuffle_block', 'shuffle_branch2'])
@pytest.mark.parametrize('shape,k,dilation,leaky', [
    ((2, 24, 21, 17), 5, 1, False),    # batch 2, ragged tiles both ways
    ((1, 12, 15, 13), 5, 2, False),    # dilation 2
    ((1, 16, 12, 10), 5, 1, True),     # leaky ReLU
    ((1, 12, 11, 9), 3, 1, False),     # k=3
    ((1, 348, 65, 81), 5, 1, False),   # k16 stage 3, 513x641 input
    ((1, 1392, 33, 41), 5, 1, False),  # k16 stage 4: a cluster of 4
    # plans: one CTA per 2x4 tile; clusters of 2, 4 and 8 CTAs of 112
    # channels; odd Cb (2-byte copies in bfloat16); halo 4 (strips by
    # dilation phase)
    ((1, 48, 40, 50), 5, 1, False),
    ((1, 400, 24, 30), 5, 1, False),
    ((1, 800, 12, 14), 5, 1, False),
    ((1, 1600, 9, 11), 5, 1, False),
    ((1, 30, 9, 11), 5, 1, False),
    ((1, 64, 30, 40), 5, 2, False),
])
def test_block_kernels_match_plain(cuda, name, shape, k, dilation, leaky,
                                   dtype):
    _check_backbone_kernel(name, shape, dtype, cuda, k=k, dilation=dilation,
                           leaky=leaky)


@pytest.mark.parametrize('name', sorted(BACKBONE_KERNELS))
def test_backbone_kernels_raise_on_non_channels_last(cuda, name):
    call, _, counter = BACKBONE_KERNELS[name]
    args, kw = backbone_kernel_inputs(name, (1, 16, 9, 11), device=cuda)
    before = counter.LAUNCHES
    with pytest.raises(ValueError, match='channels_last'):
        call(args[0].contiguous(), *args[1:], **kw)
    assert counter.LAUNCHES == before


@pytest.mark.parametrize('engine,bf16,counter', [
    ('folded', False, None),
    ('dwpallas', False, dw_cuda),
    ('pallas', False, shuffle_cuda),
    ('pallas', True, shuffle_cuda),
    ('flax', True, None),
])
def test_predictor_engines_on_the_card(cuda, engine, bf16, counter):
    """A narrow ShuffleNetV2K served by each engine on the card gives the
    module graph's fields (float32, TF32 off: atol 1e-4; bfloat16
    backbone: within 5% of each head's largest value), launching its
    kernel once per non-first block (4 here)."""
    model = Factory().from_scratch(
        cocokp_head_metas(), base_net=basenetworks.ShuffleNetV2K(
            [2, 3, 2], [16, 32, 64, 128, 128]))
    module = Predictor(model=model, device=cuda, backbone_engine='flax')
    served = Predictor(model=model, device=cuda, backbone_engine=engine,
                       bf16=bf16)
    image = np.random.RandomState(0).randn(1, 97, 129, 3).astype(np.float32)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        ref = module.fields_batch(image)
        before = counter.LAUNCHES if counter else 0
        out = served.fields_batch(image)
        after = counter.LAUNCHES if counter else 0
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert after - before == (4 if counter else 0)
    for o, r in zip(out, ref):
        assert o.dtype == torch.float32 and bool(torch.isfinite(o).all())
        if bf16:
            assert float((o - r).abs().max()) <= 0.05 * float(r.abs().max())
        else:
            torch.testing.assert_close(o, r, rtol=1e-4, atol=1e-4)


#: (kernel wrapper, its plain version), by launch counter name
LAB_KERNELS = {
    'lab_interleave': (lab_kernels.lane_interleave,
                       lab_kernels.lane_interleave_plain),
    'lab_dw_valid': (lab_kernels.dw_valid, lab_kernels.dw_valid_plain),
    'lab_branch2': (lab_kernels.branch2, lab_kernels.branch2_plain),
}


def _backbone_launches():
    return [m.LAUNCHES for m in (dw_cuda, shuffle_cuda, block_cuda)]


def _check_lab_kernel(name, shape, dtype, device, batch=1, **kw):
    """The lab kernel against its plain version, TF32 off: float32 within
    1e-5 of the largest output (summation order), bfloat16 within one
    rounding step of it. The launch counts in the lab's counter only."""
    call, plain = LAB_KERNELS[name]
    args = lab_kernel_inputs(name, *shape, dtype=dtype, device=device,
                             seed=sum(shape), batch=batch)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        before = lab_kernels.LAUNCHES[name]
        backbone = _backbone_launches()
        out = call(*args, **kw)
        assert lab_kernels.LAUNCHES[name] == before + 1
        assert _backbone_launches() == backbone
        ref = plain(*args)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert out.shape == ref.shape and out.shape[0] == batch
    assert out.dtype == dtype
    assert out.is_contiguous(memory_format=torch.channels_last)
    scale = float(ref.float().abs().max())
    tol = (1e-5 if dtype == torch.float32 else 2.0 ** -7) * scale
    err = float((out.float() - ref.float()).abs().max())
    assert err <= tol, (err, tol)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('name', sorted(LAB_KERNELS))
@pytest.mark.parametrize('shape', [
    (9, 11, 8),       # C and W off 128 and 16, one ragged tile
    (13, 7, 24),      # several row tiles, a narrow image
    (61, 81, 348),    # k16 stage 3 (the lab's stage3)
])
def test_lab_kernels_match_plain(cuda, name, shape, dtype):
    _check_lab_kernel(name, shape, dtype, cuda)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('name', sorted(LAB_KERNELS))
@pytest.mark.parametrize('batch,shape', [
    (2, (13, 17, 24)),   # batch 2, ragged tiles both ways
    (1, (9, 11, 37)),    # odd C: 2-byte copies in bfloat16
    (2, (31, 41, 696)),  # the lab's stage4 at batch 2: a cluster of 4
])
def test_lab_kernels_batch_and_odd_channels(cuda, name, batch, shape,
                                            dtype):
    _check_lab_kernel(name, shape, dtype, cuda, batch=batch)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('r_tile', [None, 4, 8])
def test_lab_branch2_tile_rows(cuda, r_tile, dtype):
    """The branch2 kernel at the lab's stage2 and stage4 for each tile
    height a plan fits (a depthwise strip holds at most 8 rows), and the
    plan's own choice."""
    for shape in ((121, 161, 174), (31, 41, 696)):
        _check_lab_kernel('lab_branch2', shape, dtype, cuda, r_tile=r_tile)


@pytest.mark.parametrize('r_tile', [16, 40])
def test_lab_branch2_refuses_a_tile_that_does_not_fit(cuda, r_tile):
    args = lab_kernel_inputs('lab_branch2', 31, 41, 696, dtype=torch.bfloat16,
                             device=cuda)
    before = lab_kernels.LAUNCHES['lab_branch2']
    with pytest.raises(ValueError, match='no plan fits'):
        lab_kernels.branch2(*args, r_tile=r_tile)
    assert lab_kernels.LAUNCHES['lab_branch2'] == before


def test_lab_entry_point_on_the_card(cuda, capsys):
    """``mosaic_lab.main`` with the names that ``chip_smoke.py`` does not
    run: the plain branch2 alone and the tile-row sweep, which reports the
    heights for which no plan fits without launching them."""
    before = lab_kernels.LAUNCHES['lab_branch2']
    results = mosaic_lab.main(['branch2_xla', 'rtile'])
    out = capsys.readouterr().out
    assert [(r['stage'], r['r_tile']) for r in results] == [
        ('stage2', 8), ('stage3', 8), ('stage4', 8)]
    assert lab_kernels.LAUNCHES['lab_branch2'] > before
    assert all(r['kernel_s'] > 0 and r['rel_diff'] <= 2.0 ** -7
               for r in results)
    # 16-40 rows at stages 2 and 3; 16 and 24 at stage4 (31 rows)
    assert out.count('does not fit') == 4 + 4 + 2
    assert out.count('branch2 plain') == 3 + len(results)


# -- training on the card ---------------------------------------------------


@pytest.fixture(scope='module')
def train_batch(tmp_path_factory):
    """A batch of 2 of the port's CocoKp train pipeline at 97 px, and its
    head metas with strides."""
    from openpifpaf_tpu_torch.models.shell import assign_strides
    from openpifpaf_tpu_torch.plugins.coco.cocokp import CocoKp

    ann_file, image_dir = write_synthetic_coco(
        str(tmp_path_factory.mktemp('coco')), n_images=4, image_hw=(97, 129),
        seed=0)
    datamodule = CocoKp(train_annotations=ann_file, train_image_dir=image_dir,
                        square_edge=97, batch_size=2)
    assign_strides(datamodule.head_metas, 16)
    np.random.seed(0)
    images, targets, _ = next(iter(datamodule.train_loader()))
    return images, targets, datamodule.head_metas


def _trainer(metas, device, spatial=1, **attrs):
    from openpifpaf_tpu_torch.training import losses, optimize
    from openpifpaf_tpu_torch.training.trainer import Trainer

    model = port_narrow_shell(metas)
    optimizer, schedule = optimize.factory_optimizer(
        optimizer_args(lr=1e-4, lr_warm_up_factor=1.0),
        training_batches_per_epoch=1)
    trainer = Trainer(model, losses.Factory().factory(metas), optimizer,
                      schedule, 'unused', device=device, spatial=spatial)
    for k, v in attrs.items():
        setattr(trainer, k, v)
    return trainer


def _step(trainer, batch):
    images, targets, _ = batch
    device = trainer.device
    loss, heads = trainer.train_step(
        torch.from_numpy(images).to(device),
        tuple(torch.from_numpy(t).to(device) for t in targets))
    return float(loss), [float(h) for h in heads]


def test_cuda_train_step_matches_cpu(cuda, train_batch):
    """One step on the card against the CPU (TF32 off): losses rtol 1e-4;
    parameters, BatchNorm buffers and EMA within 5% of each tensor's
    update plus 1e-3 of the largest update, rtol 2e-6."""
    gpu, cpu = _trainer(train_batch[2], cuda), _trainer(train_batch[2], 'cpu')
    start = {k: v.clone() for k, v in cpu.model.state_dict().items()}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        loss, heads = _step(gpu, train_batch)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    ref_loss, ref_heads = _step(cpu, train_batch)
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-4)
    np.testing.assert_allclose(heads, ref_heads, rtol=0, atol=1e-4 * ref_loss)
    ours = {k: v.cpu() for k, v in gpu.model.state_dict().items()}
    ref = cpu.model.state_dict()
    names = [n for n in ref if not n.endswith('num_batches_tracked')]
    ema = dict(zip([n for n, _ in cpu.model.named_parameters()], gpu.ema))
    ref_ema = dict(zip([n for n, _ in cpu.model.named_parameters()], cpu.ema))
    for mine, theirs, keys in ((ours, ref, names),
                               (ema, ref_ema, list(ref_ema))):
        floor = max(float((theirs[n] - start[n]).abs().max()) for n in keys)
        for name in keys:
            update = float((theirs[name] - start[name]).abs().max())
            np.testing.assert_allclose(
                mine[name].cpu().numpy(), theirs[name].numpy(), rtol=2e-6,
                atol=0.05 * update + 1e-3 * floor, err_msg=name)


def test_cuda_batchnorm_updates_with_the_biased_variance(cuda):
    """flax's rule on the card: ``ra_var = 0.99 ra_var + 0.01 var`` with
    the biased batch variance (torch's own BatchNorm2d would take the
    unbiased one, n / (n - 1) larger), the mean likewise; nothing moves
    until the step commits the statistics."""
    from openpifpaf_tpu_torch.models.basenetworks import BatchNorm, \
        commit_batch_stats

    norm = BatchNorm(6, eps=1e-3, momentum=0.01).to(cuda)
    x = torch.randn(2, 6, 3, 5, device=cuda) * 2.0 + 1.0
    norm(x, True)
    assert torch.equal(norm.running_var, torch.ones(6, device=cuda))
    assert commit_batch_stats(norm) == 1
    var = x.var(dim=(0, 2, 3), unbiased=False)
    mean = x.mean(dim=(0, 2, 3))
    torch.testing.assert_close(norm.running_var, 0.99 + 0.01 * var,
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(norm.running_mean, 0.01 * mean, rtol=1e-6,
                               atol=1e-7)
    unbiased = 0.99 + 0.01 * x.var(dim=(0, 2, 3), unbiased=True)
    assert not torch.allclose(norm.running_var, unbiased, rtol=1e-5, atol=0)


def test_cuda_bf16_train_step(cuda, train_batch):
    """A bf16 step on the card near the float32 step (losses within 2e-3
    of the loss), with float32 master weights and buffers."""
    f32 = _trainer(train_batch[2], cuda)
    bf16 = _trainer(train_batch[2], cuda, bf16=True)
    loss, heads = _step(bf16, train_batch)
    ref_loss, ref_heads = _step(f32, train_batch)
    np.testing.assert_allclose(loss, ref_loss, rtol=2e-3)
    np.testing.assert_allclose(heads, ref_heads, rtol=0, atol=2e-3 * ref_loss)
    assert all(v.dtype != torch.bfloat16
               for v in bf16.model.state_dict().values())
    assert all(torch.isfinite(v).all() for v in bf16.model.state_dict().values())


def _no_tf32_fields(model, image, device):
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        return Predictor(model=model, device=device).fields_batch(image)
    finally:
        torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.parametrize('base_name,norm', [('resnet50', 'batch'),
                                            ('shufflenetv2k16', 'group')])
def test_cuda_backbone_fields_match_cpu(cuda, base_name, norm):
    """A full-width resnet50 and a group-norm k16 with the cocokp heads on
    the card against the CPU (TF32 off): within 1e-4 of each head's
    largest value."""
    from openpifpaf_tpu_torch.models import factory as models_factory
    saved = dict(models_factory.SHUFFLENETV2K_OPTIONS)
    models_factory.SHUFFLENETV2K_OPTIONS['norm'] = norm
    try:
        model = Factory(base_name).from_scratch(cocokp_head_metas())
    finally:
        models_factory.SHUFFLENETV2K_OPTIONS.update(saved)
    image = np.random.RandomState(1).randn(1, 129, 161, 3).astype(np.float32)
    ref = _no_tf32_fields(model, image, 'cpu')
    out = _no_tf32_fields(model, image, cuda)
    for o, r in zip(out, ref):
        scale = float(r.abs().max())
        assert scale > 0.0
        torch.testing.assert_close(o.cpu(), r, rtol=0, atol=1e-4 * scale)


def test_cuda_auto_engine_on_group_norm_k20(cuda):
    """'auto' serves a group-norm k20 (128-aligned halves) on the module
    graph, as JAX falls back when its fold fails; an explicit engine
    raises."""
    model = Factory().from_scratch(
        cocokp_head_metas(), base_net=basenetworks.ShuffleNetV2K(
            [1, 1, 1], [32, 512, 1024, 2048, 2048], norm='group'))
    assert Predictor(model=model, device=cuda)._backbone is None
    for engine in ('folded', 'dwpallas', 'pallas'):
        with pytest.raises(ValueError, match='fold'):
            Predictor(model=model, device=cuda, backbone_engine=engine)


def test_cuda_eval_cli_writes_stats(cuda, tmp_path):
    """``python -m openpifpaf_tpu_torch.eval`` on the card (its default
    device) over a synthetic set with a saved resnet50 checkpoint."""
    import json
    import os
    import subprocess
    import sys
    from openpifpaf_tpu_torch.training import checkpoint
    from openpifpaf_tpu_torch.training.checkpoint import headmeta_to_dict

    ann_file, image_dir = write_synthetic_coco(str(tmp_path / 'coco'),
                                               n_images=3)
    metas = cocokp_head_metas()
    model = Factory('resnet50').from_scratch(metas)
    ckpt = str(tmp_path / 'resnet50')
    checkpoint.save(ckpt, state_dict=model.state_dict(), meta={
        'base_name': 'resnet50', 'head_metas': [headmeta_to_dict(m)
                                                for m in metas]})
    out = str(tmp_path / 'eval')
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    done = subprocess.run(
        [sys.executable, '-m', 'openpifpaf_tpu_torch.eval', '--dataset',
         'cocokp', '--checkpoint', ckpt, '--cocokp-val-annotations',
         ann_file, '--cocokp-val-image-dir', image_dir,
         '--coco-eval-long-edge', '129', '--eval-loader-warmup', '0',
         '--output', out],
        env=dict(os.environ, PYTHONPATH=repo), capture_output=True,
        text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    with open(out + '.stats.json') as f:
        stats = json.load(f)
    assert len(stats['stats']) == 10 and np.all(np.isfinite(stats['stats']))
    assert stats['n_images'] == 3 and stats['nn_time'] > 0


def test_cuda_tracking_forward_matches_cpu(cuda):
    """A full-width tshufflenetv2k16 tracking shell (seed 0) on two frames
    on the card against the CPU (TF32 off), through the Predictor's split
    (backbone per frame, heads on [frame, previous frame]): within 1e-4 of
    each head's largest value."""
    from openpifpaf_tpu_torch.datasets import factory as datasets_factory
    model = Factory('tshufflenetv2k16').from_scratch(
        datasets_factory('cocokpst').head_metas)
    frames = np.random.RandomState(3).randn(2, 129, 161, 3).astype(
        np.float32)
    fields = {}
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for device in ('cpu', cuda):
            predictor = Predictor(model=model, device=device)
            fields[str(device)] = [
                [f.cpu() for f in predictor.fields_batch(frame[None])]
                for frame in frames]
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    for out, ref in zip(fields[str(cuda)], fields['cpu']):
        assert [tuple(r.shape) for r in ref] == [
            (1, 17, 5, 9, 17), (1, 19, 8, 9, 17), (1, 17, 8, 9, 17)]
        for o, r in zip(out, ref):
            scale = float(r.abs().max())
            assert scale > 0.0
            torch.testing.assert_close(o, r, rtol=0, atol=1e-4 * scale)


def test_cuda_tracking_golden_sequence(cuda):
    """The port's tracking ``Multi`` (CifCaf and TrackingPose, CifHr
    'auto': the kernel) on the tracking golden file's frames gives the JAX
    annotations and track ids of each frame."""
    golden = np.load(TRACKING_GOLDEN)
    reset_port_track_ids()
    multi = port_tracking_decoder(GOLDEN_STRIDE)
    frames = tracking_golden_fields(golden)
    before = cifhr_cuda.LAUNCHES
    decoded = decode_frames(multi, frames,
                            lambda f: torch.from_numpy(f).to(cuda))
    assert cifhr_cuda.LAUNCHES - before >= 2 * len(frames)
    for t, anns in enumerate(decoded):
        assert_tracking_frame(anns, golden[f'frame{t}_poses'],
                              golden[f'frame{t}_ids'], label=f'frame {t}')


def test_cuda_cocokpst_train_step(cuda, tmp_path):
    """One cocokpst train step of a narrow tracking shell on the card: an
    interleaved batch of 2 pairs (4 frames at 97 px) from the port's
    cocokpst pipeline, a finite loss for every component of the cif,
    caf and tcaf heads, and the parameters updated."""
    from openpifpaf_tpu_torch.datasets import factory as datasets_factory
    from openpifpaf_tpu_torch.models.tracking import TrackingShell
    from openpifpaf_tpu_torch.plugins.coco.cocokp import CocoKp

    ann_file, image_dir = write_synthetic_coco(str(tmp_path), n_images=4,
                                               image_hw=(97, 129), seed=0)
    saved = (CocoKp.train_annotations, CocoKp.train_image_dir,
             CocoKp.square_edge)
    CocoKp.train_annotations, CocoKp.train_image_dir = ann_file, image_dir
    CocoKp.square_edge = 97
    try:
        datamodule = datasets_factory('cocokpst')
        assign_strides(datamodule.head_metas, 16)
        datamodule.batch_size = 4
        np.random.seed(0)
        images, targets, metas = next(iter(datamodule.train_loader()))
    finally:
        (CocoKp.train_annotations, CocoKp.train_image_dir,
         CocoKp.square_edge) = saved
    assert images.shape == (4, 97, 97, 3) and len(metas) == 2
    trainer = _trainer(datamodule.head_metas, cuda)
    assert isinstance(trainer.model, TrackingShell)
    before = [p.detach().clone() for p in trainer.model.parameters()]
    loss, heads = _step(trainer, (images, targets, None))
    assert np.isfinite(loss)
    assert len(heads) == 9 and np.all(np.isfinite(heads))
    assert any(not torch.equal(b, p.detach())
               for b, p in zip(before, trainer.model.parameters()))


@pytest.mark.parametrize('scene', CIFDET_SCENES)
@pytest.mark.parametrize('config', sorted(CIFDET_CONFIGS))
def test_cuda_cifdet_decode_matches_golden(cuda, scene, config):
    """The detection decode on CUDA fields stays on the card and gives the
    JAX detections of ``golden/torch_cifdet_golden.npz`` on every seed
    slot (the same keep mask and categories, scores within 2e-6, boxes
    within 1e-3 px), and ``decoder.CifDet`` the kept ones."""
    from openpifpaf_tpu_torch import headmeta
    from openpifpaf_tpu_torch.decoder import CifDet
    from openpifpaf_tpu_torch.ops.decode_cifdet import build_cifdet_decoder

    golden = np.load(CIFDET_GOLDEN)
    fields = torch.from_numpy(cifdet_golden_fields(golden)[scene][None]).to(
        cuda)
    meta = headmeta.CifDet('cifdet', 'cocodet',
                           categories=[f'c{i}' for i in range(80)])
    meta.head_index, meta.base_stride = 0, CIFDET_STRIDE
    decoder = CifDet([meta])
    decoder.config = dataclasses.replace(decoder.config,
                                         **CIFDET_CONFIGS[config])
    out = build_cifdet_decoder(stride=CIFDET_STRIDE,
                               config=decoder.config)(fields)
    assert all(v.device == fields.device for v in out.values())
    ref = {k: golden[f'{scene}_{config}_{k}']
           for k in ('category', 'score', 'box', 'keep')}
    assert_det_gate({k: v[0].cpu().numpy() for k, v in out.items()}, ref)
    annotations, = decoder.batch_decode([fields])
    kept = np.flatnonzero(ref['keep'])
    kept = kept[np.argsort(-ref['score'][kept], kind='stable')]
    assert [a.category_id for a in annotations] == list(ref['category'][kept])


@pytest.mark.parametrize('engine,counter', [('dwpallas', dw_cuda),
                                            ('pallas', shuffle_cuda)])
def test_cocodet_engines_equal_the_module_graph(cuda, engine, counter):
    """A full-width shufflenetv2k16 with the cocodet head (random, seed 0)
    served by each kernel engine gives the module graph's fields (float32,
    TF32 off: atol 1e-4) of shape (80, 6, 33, 41), with 13 launches of
    its kernel per forward."""
    from openpifpaf_tpu_torch.datasets import factory as datasets_factory

    metas = datasets_factory('cocodet').head_metas
    module = Predictor(head_metas=metas, device=cuda, backbone_engine='flax')
    served = Predictor(model=module.model, device=cuda, backbone_engine=engine)
    image = np.random.RandomState(0).randn(1, 513, 641, 3).astype(np.float32)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        ref = module.fields_batch(image)
        before = counter.LAUNCHES
        out = served.fields_batch(image)
        after = counter.LAUNCHES
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert after - before == 13
    assert [tuple(o.shape) for o in out] == [(1, 80, 6, 33, 41)]
    torch.testing.assert_close(out[0], ref[0], rtol=1e-4, atol=1e-4)


def _narrow_predictor(metas, device):
    model = port_narrow_shell(metas)
    return Predictor(model=model, device=device)


def test_cuda_hflip_tta_fields_match_cpu(cuda):
    """hflip TTA of a narrow k16 with the cocokp and cocodet heads on the
    card against the same model on the CPU (TF32 off: atol 1e-4), on a
    width the bucket pad widens; the CifDet head keeps its direct
    field."""
    from openpifpaf_tpu_torch.datasets import factory as datasets_factory

    metas = datasets_factory('cocokp-cocodet').head_metas
    gpu = _narrow_predictor(metas, cuda)
    cpu = Predictor(model=port_narrow_shell(metas), device='cpu')
    cpu.model.load_state_dict(gpu.model.state_dict())
    image = np.random.RandomState(0).randn(2, 97, 113, 3).astype(np.float32)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        plain = gpu.fields_batch(image)
        gpu.hflip_tta = cpu.hflip_tta = True
        out = gpu.fields_batch(image)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    ref = cpu.fields_batch(image)
    for o, r in zip(out, ref):
        torch.testing.assert_close(o.cpu(), r, rtol=1e-4, atol=1e-4)
    assert torch.equal(out[2], plain[2])


def test_cuda_chunked_forward_matches_unchunked(cuda):
    """A batch of 16 on the card runs as two forwards of 8; the fields
    agree with the unchunked forward within the engine tolerance."""
    predictor = _narrow_predictor(cocokp_head_metas(), cuda)
    image = np.random.RandomState(1).randn(16, 97, 129, 3).astype(np.float32)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        predictor.nn_chunk_size = 8
        chunked = predictor.fields_batch(image)
        predictor.nn_chunk_size = 0
        whole = predictor.fields_batch(image)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    for c, w in zip(chunked, whole):
        torch.testing.assert_close(c, w, rtol=1e-4, atol=1e-4)


def test_cuda_prefetch_and_image_lists_answer_alike(cuda):
    """Prefetch at depth 2 and 0, and ``numpy_images`` against
    ``pil_images``, give the same predictions on the card."""
    import PIL.Image

    predictor = _narrow_predictor(cocokp_head_metas(), cuda)
    images = [np.random.RandomState(i).randint(0, 256, (97, 129, 3),
                                               dtype=np.uint8)
              for i in range(3)]
    answers = []
    for depth in (2, 0):
        predictor.prefetch_depth = depth
        answers.append([[a.json_data() for a in pred]
                        for pred, _, _ in predictor.numpy_images(images)])
    answers.append([[a.json_data() for a in pred]
                    for pred, _, _ in predictor.pil_images(
                        [PIL.Image.fromarray(im) for im in images])])
    assert answers[0] == answers[1] == answers[2]


def test_cuda_cocokp_cocodet_steps(cuda, tmp_path):
    """Three steps of a narrow k16 with the cocokp and cocodet heads on
    the mix's batches (cocokp, cocodet, cocokp at weights 2 1) on the
    card: finite losses, None for the absent heads, every head moved."""
    from openpifpaf_tpu_torch.datasets import MultiDataModule
    from openpifpaf_tpu_torch.datasets import factory as datasets_factory
    from openpifpaf_tpu_torch.plugins.coco.cocodet import CocoDet
    from openpifpaf_tpu_torch.plugins.coco.cocokp import CocoKp
    from torch_port_helpers import restored_statics, write_synthetic_cocodet

    kp = write_synthetic_coco(str(tmp_path / 'kp'), n_images=4,
                              image_hw=(97, 129), seed=0)
    det = write_synthetic_cocodet(str(tmp_path / 'det'), n_images=2,
                                  image_hw=(97, 129), seed=1)
    with restored_statics(CocoKp, CocoDet, MultiDataModule):
        CocoKp.train_annotations, CocoKp.train_image_dir = kp
        CocoDet.train_annotations, CocoDet.train_image_dir = det
        CocoKp.square_edge = CocoDet.square_edge = 97
        MultiDataModule.weights = [2.0, 1.0]
        datamodule = datasets_factory('cocokp-cocodet')
        datamodule.batch_size = 2
        assign_strides(datamodule.head_metas, 16)
        np.random.seed(0)
        batches = list(datamodule.train_loader())
    trainer = _trainer(datamodule.head_metas, cuda)
    before = [p.detach().clone() for p in trainer.model.head_nets.parameters()]
    pattern = []
    for images, targets, metas in batches:
        targets = trainer._prepare_targets(targets, metas)
        loss, heads = trainer.train_step(
            torch.from_numpy(images).to(cuda), targets)
        assert np.isfinite(float(loss))
        pattern.append([h is None for h in heads])
    assert pattern == [[False] * 6 + [True] * 2, [True] * 6 + [False] * 2,
                       [False] * 6 + [True] * 2]
    assert all(not torch.equal(b, p.detach()) for b, p in zip(
        before, trainer.model.head_nets.parameters()))


def test_cuda_reference_pickle_served_through_pallas(cuda, tmp_path):
    """A full-width reference-layout k16 pickle (``torch_ref``, BatchNorm
    running statistics as a reference checkpoint holds them) served
    through ``Predictor(checkpoint=..., backbone_engine='pallas')``: the
    raw head outputs on the fold of the converted weights within rtol and
    atol 1e-4 (``chip_smoke.ENGINE_TOL``) of the ``torch_ref`` forward on
    the card (TF32 off), the fused-block kernel launching 13 times per
    forward."""
    from torch_port_helpers import reference_k16, save_reference_checkpoint

    shell = reference_k16(seed=0, bn_seed=1)
    path = save_reference_checkpoint(str(tmp_path / 'ref.pkl'), shell,
                                     basenet='shufflenetv2k16')
    predictor = Predictor(checkpoint=path, device=cuda,
                          backbone_engine='pallas')
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(1, 3, 513, 641).astype(np.float32)).to(
        cuda)
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            ref = shell.to(cuda)(x)
            before = shuffle_cuda.LAUNCHES
            features = predictor._backbone(
                x.contiguous(memory_format=torch.channels_last)).float()
            launches = shuffle_cuda.LAUNCHES - before
            raw = predictor.model.heads(features, train=True)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    assert launches == 13
    for o, r in zip(raw, ref):
        torch.testing.assert_close(o, r, rtol=1e-4, atol=1e-4)


def test_cuda_golden_decoding_order_drawn(cuda, tmp_path):
    """The golden 3-person scene decoded on the card by a decoder that
    ``show.configure`` of ``--show-decoding-order --show-frontier-order``
    switched to export its orders: JAX's poses and orders, drawn with
    both overlays (needs matplotlib)."""
    import argparse
    pytest.importorskip('matplotlib')
    import PIL.Image
    from openpifpaf_tpu_torch import show
    from torch_port_helpers import drawing_statics

    golden = np.load(GOLDEN)
    key = 'sparse_decoding_order'
    with drawing_statics('openpifpaf_tpu_torch'):
        parser = argparse.ArgumentParser()
        show.cli(parser)
        show.configure(parser.parse_args(['--show-decoding-order',
                                          '--show-frontier-order']))
        decoder = port_decoder(GOLDEN_STRIDE, GOLDEN_SPARSE_FLAGS)
        fields, _ = golden_inputs(golden, 'sparse', 'decoding_order', key,
                                  cuda)
        anns = decoder.batch_decode(fields)[0]
        assert_pose_gate(list(pose_rows(anns)), list(golden[f'{key}_poses']))
        np.testing.assert_array_equal(order_rows(anns),
                                      golden[f'{key}_order'])
        path = str(tmp_path / 'golden.png')
        with show.image_canvas(np.full((513, 641, 3), 128, np.uint8), path,
                               show=False) as ax:
            show.AnnotationPainter().annotations(ax, anns)
    assert PIL.Image.open(path).size == (641, 513)


def test_cuda_exported_decode_launches_the_kernel(cuda, tmp_path,
                                                  monkeypatch):
    """A narrow shell with posed heads (``posed_model``) exported with the
    decoder for the card, saved and loaded: its one CifHr call launches
    the kernel (counted), the map is bit-equal to the plain version on
    the same cells, and the poses equal the eager decode's on the card."""
    from openpifpaf_tpu_torch import export
    from openpifpaf_tpu_torch.ops.decode_cifcaf import build_cifcaf_decoder
    from torch_port_helpers import posed_model

    model = posed_model(port_narrow_shell(cocokp_head_metas()))
    path = str(tmp_path / 'narrow.pt2')
    torch.export.save(export.export_program(
        model, input_shape=(1, 97, 129, 3), with_decoder=True, device=cuda),
        path)
    loaded = torch.export.load(path)
    program = loaded.module()
    image = torch.randn((1, 97, 129, 3), device=cuda,
                        generator=torch.Generator(cuda).manual_seed(0))

    # the program's only copies to the host: each fixpoint's "changed?"
    # flag, which its while_loop reads once per round
    host_copies = {}
    for name, module in loaded.graph_module.named_modules():
        for node in module.graph.nodes:
            if node.op == 'call_function' and str(node.target).startswith(
                    ('aten.to.', 'aten._to_copy')) and any(
                        isinstance(a, torch.device) and a.type == 'cpu'
                        for a in (*node.args, *node.kwargs.values())):
                host_copies.setdefault(name, []).append(
                    node.meta['val'].dtype)
    assert host_copies == {f'while_loop_body_graph_{i}': [torch.bool]
                           for i in range(3)}

    calls = []
    launch_counted = cifhr_cuda.launch_counted

    def kept(x, y, sigma, w, **kw):
        out = launch_counted(x, y, sigma, w, **kw)
        calls.append(((x.clone(), y.clone(), sigma.clone(), w.clone()), kw,
                      out.clone()))
        return out

    monkeypatch.setattr(cifhr_cuda, 'launch_counted', kept)
    before = cifhr_cuda.LAUNCHES
    poses, keep, order = program(image)
    torch.cuda.synchronize()
    assert cifhr_cuda.LAUNCHES == before + 1 and len(calls) == 1
    cells, kw, out = calls[0]
    assert out.shape == (17, 97, 129)
    assert torch.equal(out, cifhr.accumulate_dense(*cells, **kw))
    monkeypatch.undo()

    with torch.no_grad():
        cif, caf = model(image)
        eager = build_cifcaf_decoder(stride=16, skeleton=model.head_metas[1]
                                     .skeleton, n_keypoints=17)(cif, caf)
    for a, b in zip((poses, keep, order), eager):
        assert torch.equal(a, b)
    assert keep.sum() >= 1


def test_cuda_pipelined_loop_equals_strict_on_a_side_stream(cuda,
                                                            monkeypatch):
    """The pipelined serving loop on the card (a narrow shell with posed
    heads, batches of 2): the annotations equal the strict loop's and
    ``--decode-device 0``'s bit for bit; every CifHr call is a counted
    launch on the decode's side stream, not the default one, bit-equal to
    its plain version."""
    import argparse
    from openpifpaf_tpu_torch import decoder
    from openpifpaf_tpu_torch.decoder.cifcaf import side_stream
    from torch_port_helpers import posed_model, restored_statics

    calls = []
    launch_counted = cifhr_cuda.launch_counted

    def kept(x, y, sigma, w, **kw):
        out = launch_counted(x, y, sigma, w, **kw)
        calls.append((torch.cuda.current_stream(cuda),
                      (x.clone(), y.clone(), sigma.clone(), w.clone()), kw,
                      out.clone()))
        return out

    monkeypatch.setattr(cifhr_cuda, 'launch_counted', kept)
    rng = np.random.RandomState(3)
    images = [rng.randint(0, 256, (97, 129, 3), dtype=np.uint8)
              for _ in range(5)]
    model = posed_model(port_narrow_shell(cocokp_head_metas()))
    served = {}
    with restored_statics(*decoder.DECODERS):
        parser = argparse.ArgumentParser()
        decoder.cli(parser)
        for name, flags, pipelined in (
                ('strict', (), False), ('pipelined', (), True),
                ('decode_device', ('--decode-device', '0'), True)):
            decoder.configure(parser.parse_args([
                '--seed-threshold', '0.05', '--keypoint-threshold', '0.05',
                '--instance-threshold', '0.001', '--decoder-poses', '16',
                '--decoder-crowd-poses', '16', *flags]))
            predictor = Predictor(model=model, device=cuda)
            predictor.batch_size = 2
            predictor.pipeline_decode = pipelined
            before = cifhr_cuda.LAUNCHES
            start = len(calls)
            served[name] = [pose_rows(pred) for pred, _, _ in
                            predictor.numpy_images(images)]
            assert cifhr_cuda.LAUNCHES - before == len(calls) - start >= 3
    assert sum(len(p) for p in served['strict']) > 0
    for name in ('pipelined', 'decode_device'):
        for ours, ref in zip(served[name], served['strict']):
            np.testing.assert_array_equal(ours, ref)
    side = side_stream(cuda)
    for stream, cells, kw, out in calls:
        assert stream == side != torch.cuda.default_stream(cuda)
        assert torch.equal(out, cifhr.accumulate_dense(*cells, **kw))


def _spatial_predictor(model, device, engine, shards):
    """A Predictor of ``model`` whose forward splits each image's height
    over ``shards`` shards, all on ``device`` in this process (the local
    side of the halo exchange: one card holds every shard)."""
    return Predictor(model=model, device=device, backbone_engine=engine,
                     mesh=parallel.grid_mesh(spatial=shards,
                                             devices=[device] * shards))


@pytest.mark.parametrize('shards', [2, 4])
@pytest.mark.parametrize('engine,counter', [
    ('flax', None), ('dwpallas', dw_cuda), ('pallas', shuffle_cuda)])
def test_cuda_spatial_engines_on_shards(cuda, engine, counter, shards):
    """Each engine on the shards of the image's height on the card gives
    its unsharded fields (float32, TF32 off: atol 1e-4), its kernel
    launching once per non-first block (4 here) on each shard's haloed
    tile."""
    model = Factory().from_scratch(
        cocokp_head_metas(), base_net=basenetworks.ShuffleNetV2K(
            [2, 3, 2], [16, 32, 64, 128, 128]))
    ref = Predictor(model=model, device=cuda, backbone_engine=engine)
    served = _spatial_predictor(model, cuda, engine, shards)
    image = np.random.RandomState(0).randn(1, 97, 129, 3).astype(np.float32)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        want = ref.fields_batch(image)
        before = counter.LAUNCHES if counter else 0
        out = served.fields_batch(image)
        after = counter.LAUNCHES if counter else 0
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert after - before == (4 * shards if counter else 0)
    for o, r in zip(out, want):
        assert bool(torch.isfinite(o).all())
        torch.testing.assert_close(o, r, rtol=1e-4, atol=1e-4)


def test_cuda_spatial_train_step(cuda, train_batch):
    """The spatial train step with 2 shards on the card against the
    unsharded step (TF32 off): the loss within 1e-5, the parameters rtol
    1e-3, atol 1e-5."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        plain = _trainer(train_batch[2], cuda)
        sharded = _trainer(train_batch[2], cuda, spatial=2)
        sharded.model.load_state_dict(plain.model.state_dict())
        loss, _ = _step(plain, train_batch)
        sharded_loss, _ = _step(sharded, train_batch)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert abs(sharded_loss - loss) <= 1e-5 * abs(loss)
    ours = dict(sharded.model.named_parameters())
    for name, p in plain.model.named_parameters():
        torch.testing.assert_close(ours[name], p, rtol=1e-3, atol=1e-5)
