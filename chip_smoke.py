"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (non-zero exit):

1. device: a CUDA device is required; prints the card's name and power
   limit as nvidia-smi reports them;
2. build: compiles the port's kernels (``openpifpaf_tpu_torch/csrc/*.cu``:
   CifHr, depthwise conv with the lab's VALID mode, fused block with the
   lab's branch2 mode, the lab's interleave) from the sources next to this
   script, one nvcc per source, all started together;
3. CifHr kernel vs plain: ``cifhr_cuda.accumulate`` against its plain
   PyTorch version, bit for bit, on seeded random cells at the decode's
   shapes (F, K) = (17, 256), (17, 1024), (133, 256) and on the golden
   file's sparse and crowd cells at both tiers' budgets: each call's launch
   plan, one device op per call (``torch.profiler``), the call time (CUDA
   events), the device time alone, with a cold L2 (96 MB written between
   calls) and the card's write floor (``zero_`` of the map);
4. backbone kernels vs plain: ``dw_cuda.depthwise_conv``,
   ``shuffle_cuda.fused_block`` and ``block_cuda.branch2_apply`` against
   their plain versions at the three stage shapes of shufflenetv2k16 for
   one 513x641 image, plus a dilated leaky case, in float32 and bfloat16
   with TF32 off: each call's launch plan, the per-call times (CUDA
   events), the kernel's device time alone and the library call's (cuDNN,
   all its device ops) from ``torch.profiler``, and at stage 2 the
   kernel's device time with a cold L2 (96 MB written between calls);
5. golden decode: ``CifCaf.batch_decode`` on the fields of
   ``tests/golden/torch_decode_golden.npz`` (written with the JAX package)
   must give the stored JAX poses within the tie-free parity gate, go
   through the kernel and escalate the 40-person scene to the crowd tier;
   then each scene's warm batch-1 decode time;
5b. decoder configurations: the golden scenes decoded under every run of
   ``torch_port_helpers.golden_runs`` (each CifHr impl, greedy,
   block_joints, force-complete with and without the NMS before it, the
   decoding order, initial poses, each ablation, ``CifCafDense``; the
   40-person scene lazy and with force-complete through the crowd tier),
   each built from the decoder's CLI flags: the stored JAX poses within
   the gate, equal decoding orders and ids, the CifHr kernel's launches
   (some under 'auto' and 'pallas', none under 'lazy', 'dense' and the
   CifHr skip), and the warm batch-1 decode time, device ops and stream
   syncs per decode (``torch.profiler``);
6. main path: a full-width shufflenetv2k16 cocokp ``Predictor`` (random
   weights from seed 0) answers three single-image requests and one batch
   of two 481x641 images, then one request each with
   ``--force-complete-pose`` and ``--greedy`` (flags parsed by the predict
   CLI), with field shapes and values checked, and the CifHr kernel's
   launch count read around that run; each request's end-to-end, NN and
   decode time per image;
7. backbone engines: the same model served with ``backbone_engine``
   ``'dwpallas'``, ``'pallas'`` and ``'folded'`` on the same requests: each
   engine's fields equal the module graph's (TF32 off), its kernel
   launches 13 times per forward (k16's non-first blocks), and each
   request's times are printed; a bfloat16 ``'pallas'`` request gives finite
   fields close to the float32 ones;
8. branch2 path: ``block_cuda.build_mosaic_forward`` on the folded k16
   backbone gives the module graph's features with 13 branch2 launches;
9. forward profile: each engine's batch-1 NN time (CUDA events) and, from
   ``torch.profiler``, its device time, device ops and BatchNorm kernels;
10. lab: the Mosaic lab's kernels (``lab.kernels.lane_interleave``;
    ``dw_valid`` and ``branch2``, the VALID and lab modes of the depthwise
    and fused-block kernels) against their plain versions at the lab's
    three stage shapes in float32 and bfloat16 with TF32 off: each call's
    launch plan, kernel, plain and library times (CUDA events), the
    kernel's device time alone and the library call's (``torch.profiler``);
    then the lab's entry point ``lab.mosaic_lab.main(['interleave', 'dw',
    'branch2'])`` runs once with every launch count read around it (a lab
    run moves the lab's counters only);
11. training: a synthetic COCO keypoint set (80 JPEG images of 427x569
    with 1-4 people, ``torch_port_helpers.write_synthetic_coco``, seed 0)
    in a temporary directory, then (a) one train step of the full-width
    k16 with the cocokp heads on a batch of 8 at 385 px of the port's
    CocoKp pipeline on the card (TF32 off) against the same step on the
    CPU in float64 (the CPU's float32 step measures float32's own error):
    losses, parameters, BatchNorm buffers and EMA compared; (b)
    ``train.main`` in-process for 8 steps and 2 validation batches in
    float32, ``--bf16`` and ``--remat``: checkpoints and finite losses,
    the warm step time (CUDA events), images per second, peak memory and
    the loader's share of the loop's wall time; (c) the float32 run's
    checkpoint served by ``Predictor(checkpoint=...)`` on the card (the
    trainer's EMA weights, one request with its fields checked, CifHr
    launches read around it), then one more float32 step on (a)'s batch
    with its CUDA-event time, peak memory and, from ``torch.profiler``,
    device ops, stream syncs and device busy ms; (d) 40 steps on one fixed batch: the loss
    must fall. The training path runs no hand-written kernel (the step
    is cuDNN through autograd);
12. other backbones and eval: (a) every ``BASE_FACTORIES`` entry at full
    width, and a group-norm and an instance-norm k16, one float32 forward
    of the backbone on the card against the CPU (TF32 off, within 1e-4 of
    the largest value), with its shape, stride and ``out_features``; (b)
    resnet50 with the cocokp heads at the JAX defaults (stride 16, 2048
    features, random from seed 0) on the module graph that ``'auto'``
    picks: fields against the CPU, the main path's requests with the
    CifHr launches read around them (counted in the kernels line), a
    bf16 forward against float32, and the batch-1 forward profile in
    float32 and bf16; (c) ``python -m openpifpaf_tpu_torch.eval`` on the
    card over a synthetic COCO set (8 images of 427x569, seed 0) with that
    resnet50 saved as a checkpoint of the port, at long edge 641: 10 finite
    stats of every image, nn and decoder time per image; the ground truth
    as predictions through ``metric.Coco`` gives AP 1.0; ``benchmark.py``
    runs one entry over 2 images;
13. tracking: (a) a full-width tshufflenetv2k16 tracking model (the
    cocokpst heads: 17 CIF fields, 19 CAF and 17 TCAF edges; random, seed
    0) served by ``Predictor`` on 3 frames of 481x641 (padded to 513x641)
    on the card against the CPU, float32 with TF32 off, within 1e-4 of
    each head's largest value, and frame 2's Tcaf on the cached features
    of frame 1; (b) the frames of ``tests/golden/torch_tracking_golden.npz``
    (written with the JAX package) through the port's tracking ``Multi``
    (CifCaf and TrackingPose, CifHr through the kernel): each frame's
    annotations and track ids within the decode gate, CifHr launches,
    decode ms, device ops, syncs and busy time per frame; (c)
    ``openpifpaf_tpu_torch.video`` on the card over 8 synthetic JPEGs with
    that model saved as a checkpoint of the port: 8 JSON lines, per-frame
    NN ms (CUDA events), decode ms and device-busy share, peak memory,
    CifHr launches (counted in the kernels line);
14. tracking training and PoseTrack eval, on a synthetic COCO set (as in
    phase 11): (a) one cocokpst train step of the full-width
    tshufflenetv2k16 (random, seed 0) on 4 pairs (8 interleaved frames at
    385 px) of the port's cocokpst pipeline on the card against the same
    step on the CPU in float64, as in 11a; (b) ``train.main --dataset
    cocokpst --basenet tshufflenetv2k16`` for 8 steps at the JAX defaults
    (batch 8, 385 px, augmentation, SGD) in float32: warm step ms, images
    per second, loader share, peak memory, and ``load_shell`` reads the
    checkpoint as a TrackingShell, then one more step profiled (as after
    11b: device ops, syncs, busy ms, the step's peak memory); (c)
    ``eval.main --dataset
    posetrack2018 --write-predictions`` with that checkpoint over two
    synthetic PoseTrack 2018 sequences of 4 frames of 720x1280
    (``torch_port_helpers.write_synthetic_posetrack2018``, seed 0) at the
    default long edge 801, batch 1: the CifHr launches of CifCaf and of
    TrackingPose per frame (counted in the kernels line), NN and decode ms
    per frame, ``eval_reset`` once at the sequence boundary, one
    prediction JSON per sequence.

The second-to-last line is a JSON object describing the kernels (with each
one's bound: the larger of its bytes over the card's memory rate and its
operations over the peak rate of its type), the last
``{"ok": true, "device": {...}}``.
"""

import contextlib
import functools
import gc
import json
import logging
import os
import subprocess
import sys
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, 'tests', 'golden', 'torch_decode_golden.npz')
#: (n_fields, n_cells): COCO-17 at the fast and crowd tiers, wholebody-133
KERNEL_SHAPES = ((17, 256), (17, 1024), (133, 256))
HR_SHAPE = (513, 641)
IMAGE_HW = (481, 641)
#: fields at stride 16 of IMAGE_HW after the Predictor's bucket pad to 513x641
FIELD_HW = (33, 41)
#: the image of the engine, branch2 and profile phases
FORWARD_HW = (513, 641)
SOURCES = ('cifhr.cu', 'depthwise.cu', 'shuffle_block.cu', 'mosaic_lab.cu')
#: (Cb, H, W) of shufflenetv2k16's stages 2-4 for a 513x641 input: the
#: activations of the non-first blocks are (N, 2 Cb, H, W)
STAGES = ((174, 129, 161), (348, 65, 81), (696, 33, 41))
#: non-first blocks of shufflenetv2k16 (3 + 7 + 3): stride-1 depthwise
#: convs and fused blocks per forward
FORWARD_LAUNCHES = 13
#: kernel vs plain: float32 differs by summation order only; bfloat16 by
#: at most one rounding step of the largest output
F32_ATOL = 1e-5
BF16_RTOL = 2.0 ** -7
#: engine vs module graph fields, float32 with TF32 off (BatchNorm folded
#: into the weights rounds differently)
ENGINE_TOL = dict(rtol=1e-4, atol=1e-4)
#: bfloat16 backbone vs float32: max abs error within this share of the
#: head's largest field value
BF16_FIELD_RTOL = 5e-2
#: lab kernel vs plain, float32: summation order, as a share of the largest
#: output (bfloat16: BF16_RTOL)
LAB_F32_RTOL = 1e-5
#: the card's published peaks (H100 SXM data sheet; dense, at 700 W):
#: memory bytes/s, and operations/s by the inputs' type (float32 on CUDA
#: cores, bfloat16 on tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
#: float operations of one pixel of a CifHr splat in cifhr.cu (distance,
#: approx_exp, weighted add)
CIFHR_OPS_PER_PIXEL = 13
#: bytes written between calls for a cold-L2 time (the card's L2 is 50 MB)
FLUSH_BYTES = 96 << 20


def log(*args):
    print(*args, flush=True)


def card_line():
    done = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    return done.stdout.strip().splitlines()[0]


def import_port():
    """The port's modules and the test helpers (pose gate, seeded cells)
    of this checkout."""
    sys.path[:0] = [ROOT, os.path.join(ROOT, 'tests')]
    import openpifpaf_tpu_torch
    if not os.path.abspath(openpifpaf_tpu_torch.__file__).startswith(ROOT):
        raise RuntimeError('openpifpaf_tpu_torch imported from '
                           f'{openpifpaf_tpu_torch.__file__}, not {ROOT}')
    from openpifpaf_tpu_torch import _nvcc
    from openpifpaf_tpu_torch.lab import kernels as lab_kernels
    from openpifpaf_tpu_torch.lab import mosaic_lab
    from openpifpaf_tpu_torch.models import block_cuda, dw_cuda, \
        fused_inference, shuffle_cuda
    from openpifpaf_tpu_torch.ops import cifhr, cifhr_cuda
    return types.SimpleNamespace(
        nvcc=_nvcc, cifhr=cifhr, cifhr_cuda=cifhr_cuda, dw_cuda=dw_cuda,
        shuffle_cuda=shuffle_cuda, block_cuda=block_cuda,
        fused_inference=fused_inference, lab_kernels=lab_kernels,
        mosaic_lab=mosaic_lab)


@contextlib.contextmanager
def no_tf32():
    """Float32 convolutions and matmuls in full float32."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def launch_counters(port):
    return {'cifhr_accumulate': port.cifhr_cuda,
            'depthwise_conv': port.dw_cuda,
            'shuffle_block': port.shuffle_cuda,
            'shuffle_branch2': port.block_cuda}


def reset_launches(port):
    for module in launch_counters(port).values():
        module.LAUNCHES = 0
    for name in port.lab_kernels.LAUNCHES:
        port.lab_kernels.LAUNCHES[name] = 0


def read_launches(port):
    counts = {name: module.LAUNCHES
              for name, module in launch_counters(port).items()}
    counts.update(port.lab_kernels.LAUNCHES)
    return counts


def phase_build(port):
    start = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        futures = [pool.submit(port.nvcc.build, source) for source in SOURCES]
        paths = [f.result() for f in futures]
    log(f'built {", ".join(os.path.basename(p) for p in paths)} in '
        f'{time.perf_counter() - start:.1f} s')


def cuda_ms(fn, n):
    """Mean milliseconds per call over ``n`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def tensors_of(*args):
    """The tensors among ``args``, a weights dataclass (``.tensors()``)
    giving its own."""
    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif hasattr(a, 'tensors'):
            out.extend(a.tensors())
    return out


def bound(inputs, outputs, ops, dtype):
    """``(ms, 'bytes' or 'operations')``: the least time the card could take
    for the work, the larger of each input read once and each output written
    once at HBM_BYTES_PER_S, and ``ops`` operations at the peak rate of
    ``dtype``."""
    n_bytes = sum(t.numel() * t.element_size()
                  for t in tensors_of(*inputs, *outputs))
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (bytes_ms, 'bytes') if bytes_ms >= ops_ms else \
        (ops_ms, 'operations')


def conv_ops(name, args, out):
    """Operations of a backbone or lab kernel giving ``out`` from ``args``:
    two per multiply-add of its depthwise taps and 1x1 products (biases,
    activations and copies are not counted; the interleave only copies)."""
    n, _, h, w = out.shape
    if name in ('depthwise_conv', 'lab_dw_valid'):
        k = args[1].shape[-1]
        return 2 * k * k * out.numel()
    if name in ('shuffle_block', 'shuffle_branch2', 'lab_branch2'):
        w1, _, wdw = args[1].tensors()[:3]
        cb, k = w1.shape[0], wdw.shape[-1]
        return n * h * w * (4 * cb * cb + 2 * k * k * cb)
    return 0


def cifhr_splat_pixels(x, y, sigma, w, hr_h, hr_w):
    """Map pixels within one sigma of a cell of non-zero weight, summed
    over the cells: the splat work that these cells need."""
    xs = torch.arange(hr_w, dtype=torch.float32, device=x.device)
    ys = torch.arange(hr_h, dtype=torch.float32, device=x.device)
    total = torch.zeros((), dtype=torch.int64, device=x.device)
    for k in range(x.shape[1]):
        d2 = (xs[None, None, :] - x[:, k, None, None]) ** 2 + \
            (ys[None, :, None] - y[:, k, None, None]) ** 2
        total += ((d2 <= sigma[:, k, None, None] ** 2)
                  & (w[:, k, None, None] != 0)).sum()
    return int(total)


def device_ops(fn, n=1):
    """Names of the device ops of ``n`` calls of ``fn`` in one
    ``torch.profiler`` session, after one call outside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def start_profiler():
    """Profile small ops until a session records a device op: the
    profiler's first session in a process can miss every launch (and any
    session its first ones), so the sessions that count come after this."""
    x = torch.ones(1024, device='cuda')
    for _ in range(5):
        if device_ops(lambda: x.add_(1), 10):
            return
    raise AssertionError('torch.profiler recorded no device op in 5 '
                         'sessions of 10 launches')


#: calls in one session of the one-op-per-call check
OPS_CHECK_CALLS = 10
#: sessions of that check taken while they record no device op at all
PROFILER_TRIES = 3


def phase_kernel(cifhr, cifhr_cuda, device, card):
    """The CifHr kernel against its plain version, bit for bit, on seeded
    random cells at KERNEL_SHAPES and on the golden file's sparse and crowd
    cells at both tiers' budgets: its launch plan, one device op per call,
    the call time (CUDA events, host included), the device time alone, the
    device time with a cold L2 (FLUSH_BYTES written between calls) and the
    card's write floor (``zero_`` of the same map, not the same function);
    returns one row per case."""
    from openpifpaf_tpu_torch.lab.timing import device_ms
    from torch_port_helpers import cifhr_cases

    kw = dict(hr_h=HR_SHAPE[0], hr_w=HR_SHAPE[1])
    flush_buffer = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=device)
    floors = {}
    rows = []
    for label, cells in cifhr_cases(KERNEL_SHAPES, *HR_SHAPE,
                                    device).items():
        n_fields, n_cells = cells[0].shape
        plan = cifhr_cuda.plan(n_fields, n_cells, *HR_SHAPE)
        kernel = cifhr_cuda.accumulate(*cells, **kw)
        plain = cifhr.accumulate_dense(*cells, **kw)
        torch.cuda.synchronize()
        err = float((kernel - plain).abs().max())
        if not torch.equal(kernel, plain):
            raise AssertionError(f'CifHr kernel vs plain at {label}: not '
                                 f'bit-equal, max abs err {err}')
        call = functools.partial(cifhr_cuda.accumulate, *cells, **kw)
        # the profiler can miss a session's first launches, and now and
        # then every launch of a session: a session that recorded no op
        # is taken again (at most PROFILER_TRIES sessions); of what it
        # records, at most one op per call, each the kernel, and most
        # calls recorded
        for _ in range(PROFILER_TRIES):
            ops = device_ops(call, OPS_CHECK_CALLS)
            if ops:
                break
        if not (OPS_CHECK_CALLS // 2 <= len(ops) <= OPS_CHECK_CALLS
                and all('cifhr_band_kernel' in op for op in ops)):
            raise AssertionError(f'CifHr call at {label}: device ops {ops} '
                                 f'in {OPS_CHECK_CALLS} calls, want the '
                                 'kernel alone once per call')
        if n_fields not in floors:
            out = torch.empty_like(plain)
            floors[n_fields] = device_ms(out.zero_, 20)
        row = dict(case=label, err=err, ms=cuda_ms(call, 50),
                   plain_ms=cuda_ms(functools.partial(
                       cifhr.accumulate_dense, *cells, **kw), 3),
                   library_ms=None,
                   device_ms=device_ms(call, 20, 'cifhr_band_kernel'),
                   cold_ms=device_ms(call, 10, 'cifhr_band_kernel',
                                     between=flush_buffer.zero_),
                   floor_ms=floors[n_fields])
        splat = CIFHR_OPS_PER_PIXEL * cifhr_splat_pixels(*cells, *HR_SHAPE)
        row['bound_ms'], row['bound_by'] = bound(cells, [kernel], splat,
                                                 torch.float32)
        rows.append(row)
        log(f'cifhr {label} map={HR_SHAPE}: plan '
            f'{cifhr_cuda.describe(plan)}; max_abs_err {err} (bit for bit), '
            f'1 device op per call; call {row["ms"]:.4f} ms, device alone '
            f'{fmt_ms(row["device_ms"])}, cold L2 {fmt_ms(row["cold_ms"])}, '
            f'write floor (zero_ of the map, not the same function) '
            f'{fmt_ms(row["floor_ms"])}, plain {row["plain_ms"]:.3f} ms, '
            f'bound {row["bound_ms"]:.4f} ms by {row["bound_by"]} [{card}]')
    return rows


def phase_golden(cifhr_cuda, device, card):
    from openpifpaf_tpu_torch.decoder import CifCaf
    from openpifpaf_tpu_torch.models.shell import assign_strides
    from openpifpaf_tpu_torch.plugins.coco.constants import cocokp_head_metas
    from torch_port_helpers import assert_pose_gate

    golden = np.load(GOLDEN)
    names = ('sparse', 'crowd')
    fields = [torch.from_numpy(np.stack([golden[f'{n}_{head}']
                                         for n in names])).to(device)
              for head in ('cif', 'caf')]
    decoder = CifCaf(*assign_strides(cocokp_head_metas(), 16))
    before = cifhr_cuda.LAUNCHES
    annotations = decoder.batch_decode(fields)
    if cifhr_cuda.LAUNCHES <= before:
        raise AssertionError('golden decode did not launch the CifHr kernel')
    if decoder.last_escalated != [1]:
        raise AssertionError('expected the 40-person scene (and only it) to '
                             f'escalate, got {decoder.last_escalated}')
    for name, anns in zip(names, annotations):
        ours = [np.concatenate([a.data[:, 2:3], a.data[:, :2],
                                a.joint_scales[:, None]], axis=1)
                for a in anns]
        assert_pose_gate(ours, list(golden[f'{name}_poses']))
        log(f'golden {name}: {len(ours)} poses match the JAX decode')
    log(f'golden decode: crowd tier taken for image 1 only, '
        f'{cifhr_cuda.LAUNCHES - before} kernel launches')

    # warm decode time of each scene alone, batch 1 (the crowd scene
    # includes its fast-tier try and the crowd-tier re-decode)
    for i, name in enumerate(names):
        one = [f[i:i + 1] for f in fields]
        seconds = []
        for _ in range(4):
            decoder.batch_decode(one)
            seconds.append(decoder.last_decoder_time)
        log(f'golden {name} decode, batch 1, warm: median '
            f'{np.median(seconds[1:]) * 1e3:.2f} ms of '
            f'{[round(s * 1e3, 2) for s in seconds[1:]]} [{card}]')


#: the CUDA runtime calls that wait for the card, in a profiled run
SYNC_CALLS = ('cudaStreamSynchronize', 'cudaDeviceSynchronize',
              'cudaEventSynchronize')


def decode_profile(fn):
    """(device ops, stream syncs, device busy ms) of one call of ``fn``
    from ``torch.profiler``: the CUDA device events, the CUDA runtime's
    synchronising calls (less the profiler's closing one) and the sum of
    the device events' times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    ops = [e for e in events if e.device_type == DeviceType.CUDA]
    syncs = sum(e.device_type == DeviceType.CPU and e.name in SYNC_CALLS
                for e in events) - 1
    busy = sum(e.time_range.elapsed_us() for e in ops) / 1e3
    return len(ops), syncs, busy


def phase_configs(cifhr_cuda, device, card):
    """Every run of ``golden_runs`` on the card, each decoder built from
    its CLI flags: the golden JAX poses within the gate, the decoding
    order and ids where the golden file has them, the crowd tier for the
    40-person scene only, the CifHr kernel's launches as the run expects;
    then the warm batch-1 decode time (median of 5 after one), and the
    device ops, stream syncs and device busy time of one profiled
    decode."""
    from torch_port_helpers import GOLDEN_STRIDE, assert_pose_gate, \
        golden_inputs, golden_runs, order_rows, port_decoder, pose_rows

    golden = np.load(GOLDEN)
    for label, scene, config, flags, overrides, key, kernel in golden_runs():
        decoder = port_decoder(GOLDEN_STRIDE, flags, overrides)
        fields, initial = golden_inputs(golden, scene, config, key, device)

        def decode():
            return decoder.batch_decode(fields, initial)[0]

        before = cifhr_cuda.LAUNCHES
        anns = decode()
        launches = cifhr_cuda.LAUNCHES - before
        if (launches > 0) != kernel:
            raise AssertionError(f'config {label}: {launches} CifHr kernel '
                                 f'launches, want {"some" if kernel else 0}')
        assert_pose_gate(list(pose_rows(anns)), list(golden[f'{key}_poses']))
        if f'{key}_order' in golden.files:
            np.testing.assert_array_equal(order_rows(anns),
                                          golden[f'{key}_order'])
        if f'{key}_ids' in golden.files:
            ids = [-1 if a.id_ is None else a.id_ for a in anns]
            np.testing.assert_array_equal(ids, golden[f'{key}_ids'])
        want = [0] if scene == 'crowd' else []
        if decoder.last_escalated != want:
            raise AssertionError(f'config {label}: crowd tier for '
                                 f'{decoder.last_escalated}, want {want}')
        seconds = []
        for _ in range(6):
            decode()
            seconds.append(decoder.last_decoder_time)
        ms = float(np.median(seconds[1:])) * 1e3
        ops, syncs, busy = decode_profile(decode)
        log(f'config {label}: {len(anns)} poses match the JAX decode'
            f'{" (decoding order too)" if key + "_order" in golden.files else ""}'
            f', {launches} CifHr kernel launches, crowd tier for '
            f'{decoder.last_escalated}; warm batch-1 decode {ms:.2f} ms '
            f'(median of {[round(t * 1e3, 2) for t in seconds[1:]]}), '
            f'{ops} device ops, {syncs} stream syncs, device busy '
            f'{busy:.3f} ms per decode [{card}]')


def check_fields_against_cpu(predictor, device):
    """The model's fields on the GPU against the same model on the CPU, on
    a small image, with TF32 off (atol/rtol 1e-4)."""
    import copy

    rng = np.random.RandomState(1)
    image = rng.randn(1, 129, 161, 3).astype(np.float32)
    cpu_model = copy.deepcopy(predictor.model).to('cpu')
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            gpu = predictor.model(torch.from_numpy(image).to(device))
            cpu = cpu_model(torch.from_numpy(image))
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    for g, c in zip(gpu, cpu):
        np.testing.assert_allclose(g.cpu().numpy(), c.numpy(),
                                   rtol=1e-4, atol=1e-4)
    log('fields on the GPU match the CPU forward (TF32 off, atol 1e-4)')


def compare_and_time(name, case, call, plain, library, args, kw, dtype,
                     f32_tol, card):
    """``call`` against ``plain`` on ``args``, raising beyond the
    tolerance (float32: ``f32_tol(ref)``; bfloat16: one rounding step of
    the largest output), then each one's time and ``library``'s (one
    PyTorch call of the same function, or None) and the work's bound.
    Returns the row as a dict."""
    out = call(*args, **kw)
    ref = plain(*args, **kw)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    tol = f32_tol(ref) if dtype == torch.float32 else \
        BF16_RTOL * float(ref.float().abs().max())
    if not err <= tol:
        raise AssertionError(f'{name} kernel vs plain at {case}: max abs '
                             f'err {err}, tol {tol}')
    row = dict(case=case, dtype=dtype, err=err, tol=tol,
               ms=cuda_ms(functools.partial(call, *args, **kw), 20),
               plain_ms=cuda_ms(functools.partial(plain, *args, **kw), 20),
               library_ms=None if library is None else cuda_ms(
                   functools.partial(library, *args), 20))
    row['bound_ms'], row['bound_by'] = bound(args, [out],
                                             conv_ops(name, args, out), dtype)
    library_text = 'none' if library is None else \
        f'{row["library_ms"]:.4f} ms'
    log(f'{name} {case}: max_abs_err {err} (tol {tol:.3g}), kernel '
        f'{row["ms"]:.4f} ms, plain {row["plain_ms"]:.4f} ms, library '
        f'{library_text}, bound {row["bound_ms"]:.4f} ms by '
        f'{row["bound_by"]} per call [{card}]')
    return row


def launch_plan(port, name, args, kw):
    """The launch plan the wrapper of backbone or lab kernel ``name`` takes
    for ``args``, as text."""
    x = args[0]
    n, c, h, w = x.shape
    align = port.dw_cuda.alignment
    if name == 'lab_interleave':
        ctas = min(-(-x.numel() // 256), 1 << 20)
        return f'{ctas} CTAs of 256 threads, one (a, b) pair per thread'
    if name in ('depthwise_conv', 'lab_dw_valid'):
        k = args[1].shape[-1]
        valid = name == 'lab_dw_valid'
        if valid:  # planned for the output's size
            h, w = h - k + 1, w - k + 1
        p = port.dw_cuda.plan(n, h, w, c, k=k,
                              dilation=kw.get('dilation', 1), dtype=x.dtype,
                              align=align(x), valid=valid)
        return (f'vec {p.vec}, {p.nv} vectors x {p.groups} groups, tile '
                f'{p.strips * port.dw_cuda.strip_rows(p.vec)}x{p.tw}, '
                f'{p.threads} threads, {p.ctas} CTAs, {p.smem} shared bytes')
    wt = args[1]
    if name == 'lab_branch2':
        k = wt.wd.shape[-1]
        p = port.lab_kernels.branch2_plan(
            n, h - k + 1, w - k + 1, c, k=k, dtype=x.dtype,
            align=align(x, wt.w1, wt.w3))
    else:
        p = port.shuffle_cuda.plan(n, h, w, c // 2, k=kw['k'],
                                   dilation=kw['dilation'], dtype=x.dtype,
                                   align=align(x, wt.w1, wt.w3))
    resident = port.shuffle_cuda.resident_clusters(p, dtype=x.dtype,
                                                   device=x.device)
    return (f'tile {p.th}x{p.tw}, cluster {p.cluster} x {p.slice} channels, '
            f'{p.ctas} CTAs ({resident} clusters resident at once), '
            f'{p.smem} shared bytes, {p.vb}-byte copies')


#: the backbone kernels' names in their sources
BACKBONE_SYMBOLS = {'depthwise_conv': 'depthwise_kernel',
                    'shuffle_block': 'shuffle_block_kernel',
                    'shuffle_branch2': 'shuffle_block_kernel'}


def phase_backbone_kernels(port, device, card):
    """Each backbone kernel against its plain version, with its launch
    plan, its device time alone and the library call's (``torch.profiler``)
    and, at stage 2, its device time with a cold L2; returns
    {name: [row of :func:`compare_and_time`, ...]}."""
    from openpifpaf_tpu_torch.lab.timing import device_ms
    from torch_port_helpers import backbone_kernel_inputs

    kernels = {
        'depthwise_conv': (port.dw_cuda.depthwise_conv,
                           port.dw_cuda.depthwise_conv_plain),
        'shuffle_block': (port.shuffle_cuda.fused_block,
                          port.shuffle_cuda.fused_block_plain),
        'shuffle_branch2': (port.block_cuda.branch2_apply,
                            port.shuffle_cuda.branch2_plain),
    }
    # the model's stage shapes (depthwise without activation, as in the
    # model), and a small dilated leaky case
    cases = [((1, 2 * cb, h, w), 5, 1, False) for cb, h, w in STAGES]
    cases.append(((2, 24, 13, 17), 5, 2, True))
    flush_buffer = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=device)
    results = {}
    with no_tf32():
        for name, (call, plain) in kernels.items():
            results[name] = []
            symbol = BACKBONE_SYMBOLS[name]
            for dtype in (torch.float32, torch.bfloat16):
                for i, (shape, k, dilation, leaky) in enumerate(cases):
                    if name == 'depthwise_conv' and i < len(STAGES):
                        shape = (1, shape[1] // 2) + shape[2:]
                    args, kw = backbone_kernel_inputs(
                        name, shape, k=k, dilation=dilation, act=leaky,
                        leaky=leaky, dtype=dtype, device=device, seed=i)
                    case = f'{tuple(shape)} k={k} d={dilation} ' \
                        f'leaky={leaky} {str(dtype)[6:]}'
                    # one cuDNN call computes the depthwise conv without
                    # an activation; no single call computes a block
                    library = None
                    if name == 'depthwise_conv' and not leaky:
                        library = functools.partial(
                            F.conv2d, padding=(k - 1) // 2 * dilation,
                            dilation=dilation, groups=shape[1])
                    row = compare_and_time(
                        name, case, call, plain, library, args, kw, dtype,
                        lambda ref: F32_ATOL, card)
                    fn = functools.partial(call, *args, **kw)
                    row['device_ms'] = device_ms(fn, 20, symbol)
                    row['library_device_ms'] = None if library is None \
                        else device_ms(functools.partial(library, *args), 20)
                    row['cold_ms'] = device_ms(
                        fn, 10, symbol, between=flush_buffer.zero_) \
                        if i == 0 else None
                    results[name].append(row)
                    plan = launch_plan(port, name, args, kw)
                    log(f'{name} {case}: plan {plan}; device time alone '
                        f'{fmt_ms(row["device_ms"])}, cold L2 '
                        f'{fmt_ms(row["cold_ms"])}, library device '
                        f'{fmt_ms(row["library_device_ms"])} [{card}]')
    return results


def fmt_ms(ms):
    return 'not measured' if ms is None else f'{ms:.4f} ms'


def make_requests():
    rng = np.random.RandomState(0)
    requests = [[rng.randint(0, 256, IMAGE_HW + (3,), dtype=np.uint8)]
                for _ in range(3)]
    requests.append([rng.randint(0, 256, IMAGE_HW + (3,), dtype=np.uint8)
                     for _ in range(2)])
    return requests


def serve(predictor, requests, card, label):
    """Answer ``requests``, check every field's shape and values and print
    each request's times; returns the number of forwards."""
    seen = []
    fields_batch = predictor.fields_batch

    def recording_fields_batch(image_batch):
        fields = fields_batch(image_batch)
        seen.append([(tuple(f.shape), bool(torch.isfinite(f).all()))
                     for f in fields])
        return fields

    predictor.fields_batch = recording_fields_batch
    timings = []
    try:
        for images in requests:
            predictor.batch_size = len(images)
            start = time.perf_counter()
            out = list(predictor.numpy_images(images))
            e2e = time.perf_counter() - start
            if len(out) != len(images):
                raise AssertionError(f'{len(out)} answers for {len(images)}')
            timings.append((len(images), e2e, predictor.last_nn_time,
                            predictor.last_decoder_time,
                            predictor.processor.decoders[0].last_escalated,
                            [len(pred) for pred, _, _ in out]))
    finally:
        del predictor.fields_batch

    for (b, *_), shapes in zip(timings, seen):
        want = [((b, 17, 5) + FIELD_HW, True), ((b, 19, 8) + FIELD_HW, True)]
        if shapes != want:
            raise AssertionError(f'{label}: fields {shapes}, want {want}')
    for i, (b, e2e, nn_s, dec_s, escalated, n_anns) in enumerate(timings):
        log(f'{label} request {i} batch {b}: e2e {e2e / b * 1e3:.2f} '
            f'ms/image, NN {nn_s / b * 1e3:.2f} ms/image, '
            f'decode {dec_s / b * 1e3:.2f} ms/image, crowd tier for '
            f'{escalated}, annotations {n_anns}'
            f'{" (first call, warm-up)" if i == 0 else ""} [{card}]')
    return len(seen)


def flagged_predictor(model, device, flag):
    """A Predictor of ``model`` whose decoder the predict CLI configured
    with ``flag`` (the decoder's class settings are put back after)."""
    from openpifpaf_tpu_torch import decoder, predict
    from openpifpaf_tpu_torch.predictor import Predictor
    from torch_port_helpers import restored_statics

    with restored_statics(*decoder.DECODERS):
        predict.cli(['request.jpg', flag])
        return Predictor(model=model, device=device)


def phase_main_path(port, device, card):
    from openpifpaf_tpu_torch.predictor import Predictor

    predictor = Predictor(device=device)
    check_fields_against_cpu(predictor, device)
    flagged = {flag: flagged_predictor(predictor.model, device, flag)
               for flag in ('--force-complete-pose', '--greedy')}
    for flag, field in (('--force-complete-pose', 'force_complete'),
                        ('--greedy', 'greedy')):
        if not getattr(flagged[flag].processor.decoders[0].config, field):
            raise AssertionError(f'{flag} did not reach the decoder')
    reset_launches(port)
    serve(predictor, make_requests(), card, 'module graph')
    for flag, p in flagged.items():
        serve(p, make_requests()[:1], card, f'module graph {flag}')
    launches = read_launches(port)
    if launches['cifhr_accumulate'] == 0:
        raise AssertionError('main path never launched the CifHr kernel')
    log(f'main path: {launches["cifhr_accumulate"]} CifHr kernel launches')
    return predictor, launches['cifhr_accumulate']


def test_image(device):
    rng = np.random.RandomState(2)
    return torch.from_numpy(rng.randn(1, *FORWARD_HW, 3).astype(
        np.float32)).to(device)


def compare_fields(out, ref, label, **tol):
    """Largest abs difference per head; raises beyond ``tol``."""
    errs = [float((o.float() - r).abs().max()) for o, r in zip(out, ref)]
    for o, r in zip(out, ref):
        torch.testing.assert_close(o.float(), r, **tol, msg=lambda m: (
            f'{label}: {m}'))
    return errs


def phase_engines(port, predictor, device, card):
    """Each backbone engine on the module path's model and requests;
    returns {kernel name: launches in its engine's run} and the engines'
    predictors."""
    from openpifpaf_tpu_torch.predictor import Predictor

    image = test_image(device)
    with no_tf32(), torch.inference_mode():
        ref = predictor._forward(image)
    engine_kernel = {'dwpallas': 'depthwise_conv', 'pallas': 'shuffle_block',
                     'folded': None}
    launches = {}
    predictors = {'module graph': predictor}
    for engine, kernel in engine_kernel.items():
        p = Predictor(model=predictor.model, device=device,
                      backbone_engine=engine)
        predictors[engine] = p
        with no_tf32(), torch.inference_mode():
            errs = compare_fields(p._forward(image), ref, engine,
                                  **ENGINE_TOL)
        log(f'engine {engine}: fields vs module graph, max abs err per head '
            f'{errs} (TF32 off, rtol/atol {ENGINE_TOL["rtol"]})')
        reset_launches(port)
        forwards = serve(p, make_requests(), card, f'engine {engine}')
        counts = read_launches(port)
        for name in ('depthwise_conv', 'shuffle_block', 'shuffle_branch2'):
            want = FORWARD_LAUNCHES * forwards if name == kernel else 0
            if counts[name] != want:
                raise AssertionError(f'engine {engine}: {counts[name]} '
                                     f'{name} launches in {forwards} '
                                     f'forwards, want {want}')
        if kernel is not None:
            launches[kernel] = counts[kernel]
        log(f'engine {engine}: launches {counts} in {forwards} forwards')

    p16 = Predictor(model=predictor.model, device=device,
                    backbone_engine='pallas', bf16=True)
    x = image.permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    with no_tf32(), torch.inference_mode():
        pairs = list(zip(p16._forward(image), ref))
        pairs.append((p16._backbone(x).float(), predictor.model.base_net(x)))
    for what, (o, r) in zip(('cif', 'caf', 'features'), pairs):
        if not bool(torch.isfinite(o).all()):
            raise AssertionError(f'bf16 pallas: {what} not finite')
        err = float((o - r).abs().max())
        rel = err / float(r.abs().max())
        if not rel <= BF16_FIELD_RTOL:
            raise AssertionError(f'bf16 pallas: {what} error {rel} of the '
                                 f'largest value, want <= {BF16_FIELD_RTOL}')
        log(f'engine pallas bf16: {what} max abs err {err} = {rel:.3g} of '
            f'the largest float32 value (tol {BF16_FIELD_RTOL})')
    serve(p16, make_requests()[:1], card, 'engine pallas bf16')
    predictors['pallas bf16'] = p16
    return launches, predictors


def phase_branch2(port, predictor, device, card):
    """``build_mosaic_forward`` on the folded k16 backbone against the
    module graph's features; returns the branch2 launches."""
    forward = port.block_cuda.build_mosaic_forward(
        port.fused_inference.fold_shufflenet(predictor.model.base_net),
        dtype=torch.float32)
    x = test_image(device).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    with no_tf32(), torch.inference_mode():
        ref = predictor.model.base_net(x)
        reset_launches(port)
        out = forward(x)
        launches = read_launches(port)['shuffle_branch2']
    if launches != FORWARD_LAUNCHES:
        raise AssertionError(f'branch2 path: {launches} launches, want '
                             f'{FORWARD_LAUNCHES}')
    err = compare_fields([out], [ref], 'branch2 path', **ENGINE_TOL)[0]
    log(f'branch2 path: {launches} launches, features vs module graph max '
        f'abs err {err} (TF32 off) [{card}]')
    return launches


def phase_profile(predictors, device, card):
    """Batch-1 forward of each engine on FORWARD_HW: CUDA-event time (TF32 as
    PyTorch defaults it) and, from one profiled forward, device time,
    device ops and BatchNorm kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    image = test_image(device)
    for name, p in predictors.items():
        def forward():
            return p._forward(image)

        with torch.inference_mode():
            ms = cuda_ms(forward, 10)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                forward()
                torch.cuda.synchronize()
        ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in ops) / 1e3
        bn = [e for e in ops if 'bn_' in e.name or 'batch_norm' in e.name
              or 'batchnorm' in e.name.lower()]
        bn_ms = sum(e.time_range.elapsed_us() for e in bn) / 1e3
        log(f'forward {name}, batch 1, {FORWARD_HW}: {ms:.3f} ms (CUDA '
            f'events, 10 reps), device time {busy:.3f} ms in {len(ops)} '
            f'device ops, {len(bn)} BatchNorm kernels ({bn_ms:.3f} ms) '
            f'[{card}]')
        kinds = {}
        for e in bn:
            kinds[e.name[:80]] = kinds.get(e.name[:80], 0) + 1
        log(f'forward {name}: BatchNorm kernels by name {kinds}')


#: the lab kernels' sources and their kernels' names there
LAB_SYMBOLS = {'lab_interleave': ('mosaic_lab.cu', 'interleave_kernel'),
               'lab_dw_valid': ('depthwise.cu', 'depthwise_kernel'),
               'lab_branch2': ('shuffle_block.cu', 'shuffle_block_kernel')}


def phase_lab_kernels(port, device, card):
    """Each lab kernel against its plain version at the lab's three stage
    shapes, float32 and bfloat16, TF32 off, with its launch plan, its
    device time alone and the library call's (``torch.profiler``); returns
    {name: [row, ...]}."""
    from openpifpaf_tpu_torch.lab.timing import device_ms
    from torch_port_helpers import lab_kernel_inputs

    lab = port.lab_kernels
    kernels = {
        # (kernel, plain version, one PyTorch call of the same function)
        'lab_interleave': (lab.lane_interleave, lab.lane_interleave_plain,
                           lab.lane_interleave_plain),
        'lab_dw_valid': (lab.dw_valid, lab.dw_valid_plain,
                         lambda x, wt: F.conv2d(x, wt, groups=x.shape[1])),
        'lab_branch2': (lab.branch2, lab.branch2_plain, None),
    }
    results = {}
    with no_tf32():
        for name, (call, plain, library) in kernels.items():
            results[name] = []
            symbol = LAB_SYMBOLS[name][1]
            for dtype in (torch.float32, torch.bfloat16):
                for i, (stage, (h, w, c)) in enumerate(
                        port.mosaic_lab.STAGES.items()):
                    args = lab_kernel_inputs(name, h, w, c, dtype=dtype,
                                             device=device, seed=i)
                    row = compare_and_time(
                        name, f'{stage} {(h, w, c)} {str(dtype)[6:]}', call,
                        plain, library, args, {}, dtype,
                        lambda ref: LAB_F32_RTOL * float(ref.abs().max()),
                        card)
                    # the kernel's own time, without the wrapper's host time
                    row['device_ms'] = device_ms(
                        functools.partial(call, *args), 10, symbol)
                    row['library_device_ms'] = None if library is None \
                        else device_ms(functools.partial(library, *args), 10)
                    results[name].append(row)
                    log(f'{name} {row["case"]}: plan '
                        f'{launch_plan(port, name, args, {})}; device time '
                        f'alone {fmt_ms(row["device_ms"])}, library device '
                        f'{fmt_ms(row["library_device_ms"])} [{card}]')
    return results


def phase_lab(port, card):
    """The lab's entry point on its three kernels, every launch count set
    to 0 just before and read just after; returns the lab kernels'
    launches."""
    reset_launches(port)
    results = port.mosaic_lab.main(['interleave', 'dw', 'branch2'])
    counts = read_launches(port)
    lab_names = list(port.lab_kernels.LAUNCHES)
    for name, n in counts.items():
        if (n == 0) == (name in lab_names):
            raise AssertionError(f'lab run: {n} launches of {name}')
    if len(results) != 3 * len(port.mosaic_lab.STAGES):
        raise AssertionError(f'lab run: {len(results)} results')
    for r in results:
        if not (r['kernel_s'] > 0 and r['library_s'] > 0):
            raise AssertionError(f'lab run: no time in {r}')
        if r['op'] == 'branch2' and not r['rel_diff'] <= BF16_RTOL:
            raise AssertionError(f'lab run: branch2 kernel vs plain {r}')
    log(f'lab entry point: launches {counts}')
    return {name: counts[name] for name in lab_names}


#: the training phase: the JAX defaults (batch 8, 385 px crops) on a
#: synthetic COCO keypoint set of TRAIN_IMAGES images made from TRAIN_SEED
TRAIN_BATCH = 8
TRAIN_EDGE = 385
TRAIN_IMAGES = 80
TRAIN_IMAGE_HW = (427, 569)
TRAIN_SEED = 0
TRAIN_STEPS = 8
#: one step on the card (float32, TF32 off) against the same step on the
#: CPU in float64, with the CPU's float32 step as the measure of float32's
#: own error: the loss within rtol 1e-4 and each component within 1e-4 of
#: the loss; per tensor (parameters, BatchNorm buffers, EMA), the card's
#: L2 error at most 3x the CPU float32 step's plus 5% of the tensor's
#: update plus float32's rounding of the tensor (2.4e-7 of its L2 norm);
#: over each kind, the card's error at most 5% of the update (L2). On an
#: NVIDIA H100 80GB HBM3 (700 W) the card's error over the parameters
#: measured 0.9% of the update, the CPU float32 step's 8.4%.
STEP_LOSS_RTOL = 1e-4
STEP_NOISE_FACTOR = 3.0
STEP_UPDATE_RTOL = 0.05
STEP_ROUNDING = 2.4e-7
#: overfitting one batch for 40 steps (SGD, lr 1e-3, no warm-up): the
#: mean of the last 5 losses at most 0.7 of the first and 0.9 of the
#: second (this phase on the CPU at 97 px, batch 2: 0.444 and 0.727)
OVERFIT_STEPS = 40
OVERFIT_MAX_FIRST = 0.7
OVERFIT_MAX_SECOND = 0.9


def train_flags(data, out, *extra):
    ann_file, image_dir = data
    return ['--dataset', 'cocokp', '--basenet', 'shufflenetv2k16',
            '--cocokp-train-annotations', ann_file,
            '--cocokp-val-annotations', ann_file,
            '--cocokp-train-image-dir', image_dir,
            '--cocokp-val-image-dir', image_dir,
            '--cocokp-square-edge', str(TRAIN_EDGE),
            '--batch-size', str(TRAIN_BATCH), '--epochs', '1',
            '--train-batches', str(TRAIN_STEPS), '--val-batches', '2',
            '--log-interval', '1', '--seed', str(TRAIN_SEED),
            '--output', out, *extra]


def train_batch(data):
    """One batch of the port's CocoKp train pipeline (augmentation on),
    its head metas and the k16 model at full width (random, seeded)."""
    from openpifpaf_tpu_torch.models.factory import Factory
    from openpifpaf_tpu_torch.plugins.coco.cocokp import CocoKp

    ann_file, image_dir = data
    datamodule = CocoKp(train_annotations=ann_file, train_image_dir=image_dir,
                        square_edge=TRAIN_EDGE, batch_size=TRAIN_BATCH)
    model = Factory().from_scratch(
        datamodule.head_metas,
        generator=torch.Generator().manual_seed(TRAIN_SEED))
    np.random.seed(TRAIN_SEED)
    images, targets, _ = next(iter(datamodule.train_loader()))
    return images, targets, datamodule.head_metas, model


def make_trainer(model, metas, device, **flags):
    from openpifpaf_tpu_torch.training import losses, optimize
    from openpifpaf_tpu_torch.training.trainer import Trainer
    from torch_port_helpers import optimizer_args

    optimizer, schedule = optimize.factory_optimizer(
        optimizer_args(**flags), training_batches_per_epoch=1)
    return Trainer(model, losses.Factory().factory(metas), optimizer,
                   schedule, 'unused', device=device)


def step_state(trainer):
    """(state dict, EMA by name) of a trainer, in float64 on the CPU."""
    state = {k: v.detach().cpu().double()
             for k, v in trainer.model.state_dict().items()}
    ema = {n: e.detach().cpu().double() for (n, _), e in
           zip(trainer.model.named_parameters(), trainer.ema)}
    return state, ema


def compare_step(label, names, card_step, cpu32, cpu64, start):
    """The card's tensors against the float64 step (see STEP_*); returns
    the card's and the CPU float32 step's relative L2 error over
    ``names`` and the worst tensor's share of its allowance."""
    worst = (-1.0, '')
    err = {'card': 0.0, 'cpu32': 0.0}
    update = 0.0
    for n in names:
        ref = cpu64[n]
        e_card = float((card_step[n] - ref).norm())
        e_cpu = float((cpu32[n] - ref).norm())
        u = float((ref - start[n]).norm())
        allowed = (STEP_NOISE_FACTOR * e_cpu + STEP_UPDATE_RTOL * u
                   + STEP_ROUNDING * float(ref.norm()))
        worst = max(worst, (e_card / allowed if allowed else
                            float('inf') if e_card else 0.0, n))
        err['card'] += e_card ** 2
        err['cpu32'] += e_cpu ** 2
        update += u ** 2
    rel = {k: np.sqrt(v / update) for k, v in err.items()}
    if not (worst[0] <= 1.0 and rel['card'] <= STEP_UPDATE_RTOL):
        raise AssertionError(
            f'{label} on the card vs the CPU float64 step: '
            f'{worst[1]} at {worst[0]:.3f} of its allowance, {rel["card"]:.3g} '
            f'of the update over all (CPU float32: {rel["cpu32"]:.3g})')
    return rel, worst


def phase_train_step(batch, device, card, label='train step (a)'):
    """(a) One train step of the full-width model of ``batch`` on its
    batch of 8 at 385 px on the card against the same step on the CPU in
    float64 and float32 (TF32 off): losses, parameters, BatchNorm buffers
    and EMA."""
    import copy

    images, targets, metas, model = batch
    start = {k: v.detach().double() for k, v in model.state_dict().items()}
    results = {}
    for name, dev, dtype in (('card', device, torch.float32),
                             ('cpu32', torch.device('cpu'), torch.float32),
                             ('cpu64', torch.device('cpu'), torch.float64)):
        trainer = make_trainer(copy.deepcopy(model).to(dtype), metas, dev,
                               lr=1e-3, lr_warm_up_factor=1.0)
        t0 = time.perf_counter()
        with no_tf32():
            loss, head_losses = trainer.train_step(
                torch.from_numpy(images).to(dev, dtype),
                tuple(torch.from_numpy(t).to(dev, dtype) for t in targets))
        results[name] = (float(loss), [float(h) for h in head_losses],
                         *step_state(trainer), time.perf_counter() - t0)
    loss, heads, state, ema, card_s = results['card']
    ref_loss, ref_heads, ref_state, ref_ema, cpu64_s = results['cpu64']
    _, _, cpu_state, cpu_ema, cpu32_s = results['cpu32']
    head_err = max(abs(a - b) for a, b in zip(heads, ref_heads))
    if not (np.isfinite(loss)
            and abs(loss - ref_loss) <= STEP_LOSS_RTOL * abs(ref_loss)
            and head_err <= STEP_LOSS_RTOL * abs(ref_loss)):
        raise AssertionError(f'{label} losses {loss} {heads} on the '
                             f'card, {ref_loss} {ref_heads} on the CPU')
    params = [n for n, _ in model.named_parameters()]
    buffers = [n for n in start if n not in params
               and not n.endswith('num_batches_tracked')]
    for kind, names, ours, cpu32, cpu64 in (
            ('parameters', params, state, cpu_state, ref_state),
            ('BatchNorm buffers', buffers, state, cpu_state, ref_state),
            ('EMA', params, ema, cpu_ema, ref_ema)):
        rel, worst = compare_step(f'{label} {kind}', names, ours, cpu32,
                                  cpu64, start)
        log(f'{label} {kind}: error against the CPU float64 step '
            f'{rel["card"]:.3e} of the update (L2) on the card, '
            f'{rel["cpu32"]:.3e} for the CPU float32 step; worst tensor '
            f'{worst[1]} at {worst[0]:.3f} of its allowance')
    log(f'{label}: loss {loss} on the card, {ref_loss} in float64 '
        f'on the CPU, head losses within {head_err:.3g}; first step '
        f'{card_s * 1e3:.1f} ms on the card, {cpu32_s:.1f} s (float32) and '
        f'{cpu64_s:.1f} s (float64) on the CPU ({torch.get_num_threads()} '
        f'threads) [{card}]')


def timed_train_steps(trainer_cls, events):
    """Wrap ``trainer_cls.train_step`` to record CUDA events around each
    step; returns the original method."""
    original = trainer_cls.train_step

    def train_step(self, *args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = original(self, *args, **kwargs)
        end.record()
        events.append((start, end))
        return out

    trainer_cls.train_step = train_step
    return original


def read_train_log(path):
    with open(path) as f:
        lines = [json.loads(line) for line in f]
    train = [line for line in lines if line.get('type') == 'train']
    val = [line for line in lines if line.get('type') == 'val-epoch']
    return train, val


def train_run(argv, out, label, card):
    """``train.main(argv)`` in-process, writing ``out``: checkpoints
    written, every loss finite; warm step time (CUDA events), images per
    second, peak memory and the loader's share of the wall time. Returns
    the trainer."""
    from openpifpaf_tpu_torch import train
    from openpifpaf_tpu_torch.training.trainer import Trainer

    os.makedirs(os.path.dirname(out))
    events = []
    original = timed_train_steps(Trainer, events)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        trainer = train.main(argv)
    finally:
        Trainer.train_step = original
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - before
    for suffix in ('.epoch000', '.epoch001', ''):
        for ext in ('.json', '.pt'):
            if not os.path.exists(out + suffix + ext):
                raise AssertionError(f'{label}: no {out + suffix + ext}')
    train_lines, val_lines = read_train_log(out + '.log')
    losses = [line['loss'] for line in train_lines] + \
        [line['loss'] for line in val_lines]
    if len(train_lines) != TRAIN_STEPS or len(val_lines) != 1 \
            or not np.all(np.isfinite(losses)):
        raise AssertionError(f'{label}: {len(train_lines)} train lines, '
                             f'{len(val_lines)} val lines, losses '
                             f'{losses}')
    if len(events) != TRAIN_STEPS:
        raise AssertionError(f'{label}: {len(events)} timed steps')
    # warm: the steps after the first (cuDNN picks its algorithms)
    step_ms = [s.elapsed_time(e) for s, e in events][1:]
    median = float(np.median(step_ms))
    warm = train_lines[1:]
    data_s = sum(line['data_time'] for line in warm)
    time_s = sum(line['time'] for line in warm)
    log(f'{label}: warm step {median:.2f} ms median '
        f'(min {min(step_ms):.2f}, max {max(step_ms):.2f} over '
        f'{len(step_ms)} steps, CUDA events), '
        f'{TRAIN_BATCH / median * 1e3:.1f} images/s on the device '
        f'timeline, {TRAIN_BATCH * len(warm) / time_s:.1f} images/s '
        f'of wall time in the loop (loader included), loader share '
        f'{data_s / time_s:.3f} (data_time {data_s:.3f} s of '
        f'{time_s:.3f} s), peak memory {peak / 2 ** 30:.2f} GiB above '
        f'the {before / 2 ** 30:.2f} GiB held before the run; first '
        f'step {train_lines[0]["time"]:.3f} s, losses '
        f'{[round(x, 1) for x in losses]}, whole run {wall:.1f} s '
        f'[{card}]')
    return trainer


def phase_train_runs(data, directory, card):
    """(b) ``train.main`` in-process in float32, ``--bf16`` and
    ``--remat`` (:func:`train_run`). Returns the float32 run's output and
    trainer."""
    runs = {}
    for label, extra in (('float32', ()), ('bf16', ('--bf16',)),
                         ('remat', ('--remat',))):
        out = os.path.join(directory, label, 'model')
        runs[label] = (out, train_run(train_flags(data, out, *extra), out,
                                      f'train run (b) {label}', card))
    return runs['float32']


def profile_train_step(trainer, batch, label, card):
    """One more step of ``trainer`` on ``batch`` (images, targets, ...)
    under ``torch.profiler``: device ops, stream syncs and device busy ms
    against the step's CUDA-event time, and its peak memory."""
    images, targets = batch[:2]
    device = trainer.device
    images = torch.from_numpy(images).to(device)
    targets = tuple(torch.from_numpy(t).to(device) for t in targets)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    start.record()
    trainer.train_step(images, targets)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated() - before
    ops, syncs, busy = decode_profile(
        lambda: trainer.train_step(images, targets))
    log(f'{label}, one step outside the run: {step_ms:.2f} ms (CUDA '
        f'events), peak memory {peak / 2 ** 30:.2f} GiB above the '
        f'{before / 2 ** 30:.2f} GiB held; a profiled step: {ops} device '
        f'ops, {syncs} stream syncs, device busy {busy:.2f} ms [{card}]')


def phase_serve_checkpoint(port, out, trainer, device, card):
    """(c) The float32 run's checkpoint through
    ``Predictor(checkpoint=...)`` on the card: the trainer's EMA weights,
    and one request with its fields checked as the main path's are."""
    from openpifpaf_tpu_torch.predictor import Predictor

    predictor = Predictor(checkpoint=out, device=device)
    written = trainer.ema_state_dict()
    for name, value in predictor.model.state_dict().items():
        if not torch.equal(value.cpu(), written[name]):
            raise AssertionError(f'checkpoint {name} differs from the '
                                 "trainer's EMA")
    reset_launches(port)
    serve(predictor, make_requests()[:1], card, 'trained checkpoint')
    launches = read_launches(port)
    if launches['cifhr_accumulate'] == 0:
        raise AssertionError('serving the checkpoint launched no CifHr '
                             'kernel')
    log(f'serve (c): the checkpoint holds the EMA weights; '
        f'{launches["cifhr_accumulate"]} CifHr kernel launches')


def phase_overfit(batch, device, card):
    """(d) 40 steps on one fixed batch with warm-up off: the loss must
    fall (OVERFIT_MAX_FIRST, OVERFIT_MAX_SECOND)."""
    import copy

    images, targets, metas, model = batch
    trainer = make_trainer(copy.deepcopy(model), metas, device, lr=1e-3,
                           lr_warm_up_factor=1.0)
    images = torch.from_numpy(images).to(device)
    targets = tuple(torch.from_numpy(t).to(device) for t in targets)
    history = [float(trainer.train_step(images, targets)[0])
               for _ in range(OVERFIT_STEPS)]
    last = float(np.mean(history[-5:]))
    if not (np.all(np.isfinite(history))
            and last <= OVERFIT_MAX_FIRST * history[0]
            and last <= OVERFIT_MAX_SECOND * history[1]):
        raise AssertionError(f'overfit: losses {history}')
    log(f'overfit (d): loss {history[0]:.1f} -> {history[1]:.1f} -> '
        f'{last:.1f} (mean of the last 5 of {OVERFIT_STEPS}; '
        f'{last / history[0]:.3f} of the first, {last / history[1]:.3f} of '
        f'the second) [{card}]')
    log(f'overfit (d) losses: {[round(x, 1) for x in history]}')


def phase_train(port, device, card):
    """The training path: a synthetic COCO set, then (a)-(d)."""
    import tempfile
    from torch_port_helpers import write_synthetic_coco

    # the trainer's JSON lines go to each run's log file, not to stdout
    # (train.main's logging.basicConfig does nothing once root has a
    # handler)
    root = logging.getLogger('')
    root.setLevel(logging.INFO)
    root.addHandler(logging.NullHandler())
    with tempfile.TemporaryDirectory() as directory:
        data = write_synthetic_coco(os.path.join(directory, 'coco'),
                                    n_images=TRAIN_IMAGES,
                                    image_hw=TRAIN_IMAGE_HW, seed=TRAIN_SEED)
        batch = train_batch(data)
        phase_train_step(batch, device, card)
        out, trainer = phase_train_runs(data, directory, card)
        phase_serve_checkpoint(port, out, trainer, device, card)
        profile_train_step(trainer, batch, 'train run (b) float32', card)
        phase_overfit(batch, device, card)


#: phase 12: every backbone's float32 forward on the card against the CPU
#: (TF32 off) at this image size, within this share of its largest value
BACKBONE_HW = (129, 161)
BACKBONE_RTOL = 1e-4
#: phase 12c: the eval CLI on a synthetic COCO set of EVAL_IMAGES images of
#: TRAIN_IMAGE_HW made from seed 0, at the JAX default long edge
EVAL_IMAGES = 8
EVAL_LONG_EDGE = 641


def phase_backbones(device, card):
    """(a) Every ``BASE_FACTORIES`` entry at full width, and a group-norm
    and an instance-norm k16: one float32 forward of the backbone on the
    card and on the CPU, with the same weights (seed 0), TF32 off."""
    import copy
    from openpifpaf_tpu_torch.models import factory as models_factory

    image = torch.from_numpy(np.random.RandomState(3).randn(
        1, 3, *BACKBONE_HW).astype(np.float32)).contiguous(
            memory_format=torch.channels_last)
    options = models_factory.SHUFFLENETV2K_OPTIONS
    cases = [(name, 'batch') for name in sorted(models_factory.BASE_FACTORIES)]
    cases += [('shufflenetv2k16', 'group'), ('shufflenetv2k16', 'instance')]
    for name, norm in cases:
        saved = dict(options)
        options['norm'] = norm
        try:
            net = models_factory.BASE_FACTORIES[name]()
        finally:
            options.update(saved)
        models_factory.init_like_flax(net, torch.Generator().manual_seed(0))
        net = net.eval().to(memory_format=torch.channels_last)
        on_card = copy.deepcopy(net).to(device)
        with no_tf32(), torch.inference_mode():
            ref = net(image)
            out = on_card(image.to(device)).cpu()
        del on_card
        err = float((out - ref).abs().max())
        scale = float(ref.abs().max())
        if not (bool(torch.isfinite(out).all()) and scale > 0
                and err <= BACKBONE_RTOL * scale):
            raise AssertionError(f'backbone {name} ({norm} norm): error '
                                 f'{err} of largest value {scale}')
        log(f'backbone {name} ({norm} norm): features {tuple(out.shape)}, '
            f'stride {net.stride}, out_features {net.out_features}, max abs '
            f'err {err:.3g} = {err / scale:.3g} of the largest value (tol '
            f'{BACKBONE_RTOL}, TF32 off) [{card}]')


def phase_resnet50(port, device, card):
    """(b) resnet50 with the cocokp heads at the JAX defaults (stride 16,
    2048 features; random, seed 0) serving the main path's requests on the
    module graph (``'auto'``), with the CifHr launches read around them;
    then the batch-1 forward profile in float32 and bf16. Returns the model
    and the CifHr launches."""
    from openpifpaf_tpu_torch.models.factory import Factory
    from openpifpaf_tpu_torch.plugins.coco.constants import cocokp_head_metas
    from openpifpaf_tpu_torch.predictor import Predictor

    model = Factory('resnet50').from_scratch(
        cocokp_head_metas(), generator=torch.Generator().manual_seed(0))
    base = model.base_net
    if (type(base).__name__, base.stride, base.out_features) != \
            ('Resnet', 16, 2048):
        raise AssertionError(f'resnet50: {base.stride} {base.out_features}')
    predictor = Predictor(model=model, device=device)
    if predictor._backbone is not None:
        raise AssertionError("resnet50: 'auto' did not pick the module graph")
    check_fields_against_cpu(predictor, device)
    reset_launches(port)
    serve(predictor, make_requests(), card, 'resnet50')
    launches = read_launches(port)['cifhr_accumulate']
    if launches == 0:
        raise AssertionError('resnet50 serving launched no CifHr kernel')
    log(f'resnet50: {launches} CifHr kernel launches')

    p16 = Predictor(model=model, device=device, bf16=True)
    image = test_image(device)
    with torch.inference_mode():
        pairs = zip(p16._forward(image), predictor._forward(image))
        for what, (o, r) in zip(('cif', 'caf'), pairs):
            rel = float((o - r).abs().max()) / float(r.abs().max())
            if not (bool(torch.isfinite(o).all()) and rel <= BF16_FIELD_RTOL):
                raise AssertionError(f'resnet50 bf16: {what} error {rel}')
            log(f'resnet50 bf16: {what} max abs err {rel:.3g} of the largest '
                f'float32 value (tol {BF16_FIELD_RTOL})')
    phase_profile({'resnet50': predictor, 'resnet50 bf16': p16}, device,
                  card)
    return model, launches


def _port_run(module, *args):
    """``python -m module args`` of this checkout; raises on failure."""
    done = subprocess.run(
        [sys.executable, '-m', module, *args], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=600)
    if done.returncode != 0:
        raise AssertionError(f'{module} exited {done.returncode}: '
                             f'{done.stderr[-3000:]}')
    return done


def phase_eval(model, card):
    """(c) ``python -m openpifpaf_tpu_torch.eval`` on the card over a
    synthetic COCO set with the resnet50 saved as a checkpoint of the port;
    the ground truth as predictions through ``metric.Coco`` (AP 1.0); one
    ``benchmark.py`` entry over the same checkpoint."""
    import tempfile
    from openpifpaf_tpu_torch import __version__
    from openpifpaf_tpu_torch.annotation import Annotation
    from openpifpaf_tpu_torch.models import factory as models_factory
    from openpifpaf_tpu_torch.plugins.coco import constants
    from openpifpaf_tpu_torch.plugins.coco.cocokp import CocoKp
    from openpifpaf_tpu_torch.training import checkpoint
    from torch_port_helpers import restored_statics, write_synthetic_coco

    with tempfile.TemporaryDirectory() as directory:
        ann_file, image_dir = write_synthetic_coco(
            os.path.join(directory, 'coco'), n_images=EVAL_IMAGES,
            image_hw=TRAIN_IMAGE_HW, seed=0)
        ckpt = os.path.join(directory, 'resnet50')
        checkpoint.save(ckpt, state_dict=model.state_dict(), meta={
            'base_name': 'resnet50', 'epoch': 0, 'version': __version__,
            'backbone_options': {
                'shufflenetv2k': dict(models_factory.SHUFFLENETV2K_OPTIONS),
                'resnet': dict(models_factory.RESNET_OPTIONS)},
            'head_metas': [checkpoint.headmeta_to_dict(m)
                           for m in model.head_metas]})
        with restored_statics(CocoKp):
            CocoKp.eval_annotations = ann_file
            CocoKp.eval_image_dir = image_dir
            datamodule = CocoKp()
            n_images = len(datamodule.eval_loader().dataset)
            metric = datamodule.metrics()[0]
        flags = ['--dataset', 'cocokp', '--cocokp-val-annotations', ann_file,
                 '--cocokp-val-image-dir', image_dir, '--coco-eval-long-edge',
                 str(EVAL_LONG_EDGE), '--eval-loader-warmup', '0']
        out = os.path.join(directory, 'eval')
        t0 = time.perf_counter()
        _port_run('openpifpaf_tpu_torch.eval', *flags, '--checkpoint', ckpt,
                  '--output', out)
        wall = time.perf_counter() - t0
        with open(out + '.stats.json') as f:
            stats = json.load(f)
        if not (len(stats['stats']) == 10
                and np.all(np.isfinite(stats['stats']))
                and stats['n_images'] == n_images > 0
                and stats['nn_time'] > 0 and stats['decoder_time'] > 0
                and stats['file_size'] == os.path.getsize(ckpt + '.pt')):
            raise AssertionError(f'eval stats {stats}, {n_images} images')
        per_image = {k: stats[k] / n_images * 1e3
                     for k in ('total_time', 'nn_time', 'decoder_time')}
        log(f'eval (c): resnet50 over {n_images} images at long edge '
            f'{EVAL_LONG_EDGE}: per image total {per_image["total_time"]:.2f} '
            f'ms, nn {per_image["nn_time"]:.2f} ms, decoder '
            f'{per_image["decoder_time"]:.2f} ms (the first image included); '
            f'stats {[round(v, 4) for v in stats["stats"]]} (random '
            f'weights); whole command {wall:.1f} s [{card}]')

        with open(ann_file) as f:
            data = json.load(f)
        for image in data['images']:
            metric.accumulate([
                Annotation(constants.COCO_KEYPOINTS,
                           constants.COCO_PERSON_SKELETON).set(
                    np.asarray(a['keypoints'], np.float32).reshape(17, 3),
                    fixed_score=1.0, fixed_bbox=a['bbox'])
                for a in data['annotations'] if a['image_id'] == image['id']],
                {'image_id': image['id']})
        gt_stats = metric.stats()['stats']
        if gt_stats[0] != 1.0:
            raise AssertionError(f'ground truth as predictions: {gt_stats}')
        log(f'eval (c): the ground truth as predictions gives AP '
            f'{gt_stats[0]}, AR {gt_stats[5]}')

        bench = os.path.join(directory, 'bench')
        done = _port_run('openpifpaf_tpu_torch.benchmark', '--checkpoints',
                         ckpt, '--output', bench, '--n-images', '2', *flags)
        with open(os.path.join(bench, ckpt.replace('/', '-')
                               + '.eval-cocokp.stats.json')) as f:
            bench_stats = json.load(f)
        if bench_stats['n_images'] != 2:
            raise AssertionError(f'benchmark stats {bench_stats}')
        log('eval (c): benchmark.py, one entry over 2 images:')
        log(done.stdout.strip())


def phase_other_backbones(port, device, card):
    """Phase 12: (a)-(c); returns the CifHr launches of (b)."""
    phase_backbones(device, card)
    model, launches = phase_resnet50(port, device, card)
    phase_eval(model, card)
    return launches


#: phase 13: frames of the tracking forward and of the video CLI
TRACKING_FRAMES = 3
VIDEO_FRAMES = 8
#: tracking fields on the card against the CPU, float32 with TF32 off:
#: max abs error within this share of each head's largest value
TRACKING_RTOL = 1e-4


def tracking_model(metas=None):
    """A full-width tshufflenetv2k16 with ``metas`` (default: the cocokpst
    heads, 17 CIF fields, 19 CAF and 17 TCAF edges), random from seed 0."""
    from openpifpaf_tpu_torch.datasets import factory
    from openpifpaf_tpu_torch.models.factory import Factory
    return Factory('tshufflenetv2k16').from_scratch(
        metas or factory('cocokpst').head_metas,
        generator=torch.Generator().manual_seed(0))


def compare_heads(out, ref, label):
    """Each head's max abs error against ``ref`` (CPU tensors), raising
    beyond TRACKING_RTOL of the head's largest value."""
    errs = []
    for o, r in zip(out, ref):
        scale = float(r.abs().max())
        err = float((o.cpu() - r).abs().max())
        if not (scale > 0.0 and err <= TRACKING_RTOL * scale):
            raise AssertionError(f'{label}: max abs err {err}, largest '
                                 f'value {scale}')
        errs.append(err / scale)
    return errs


def phase_tracking_forward(device, card):
    """13a: the tracking forward of ``Predictor`` on the card against the
    CPU, frame by frame (backbone on the new frame, heads on [new,
    previous]); frame 2's Tcaf must be the heads on [frame 2, frame 1]
    and differ from frame 2 paired with itself."""
    import copy
    from openpifpaf_tpu_torch.predictor import Predictor

    model = tracking_model()
    gpu = Predictor(model=model, device=device)
    cpu = Predictor(model=copy.deepcopy(model), device='cpu')
    rng = np.random.RandomState(4)
    images = [gpu.preprocess(rng.randint(0, 256, IMAGE_HW + (3,),
                                         dtype=np.uint8), [], None)[0]
              for _ in range(TRACKING_FRAMES)]
    nn_ms = []
    with no_tf32():
        for i, image in enumerate(images):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = gpu.fields_batch(image[None])
            end.record()
            torch.cuda.synchronize()
            nn_ms.append(start.elapsed_time(end))
            ref = cpu.fields_batch(image[None])
            want = [(1, 17, 5) + FIELD_HW, (1, 19, 8) + FIELD_HW,
                    (1, 17, 8) + FIELD_HW]
            if [tuple(o.shape) for o in out] != want:
                raise AssertionError(f'tracking fields {out}, want {want}')
            errs = compare_heads(out, ref, f'tracking frame {i}')
            log(f'tracking (13a) frame {i}: fields on the card match the '
                f'CPU (TF32 off), max abs err / largest value cif '
                f'{errs[0]:.2e} caf {errs[1]:.2e} tcaf {errs[2]:.2e}')
        with torch.inference_mode():
            x1, x2 = (torch.from_numpy(gpu._bucket_pad(im[None])).to(device)
                      for im in images[:2])
            f1, f2 = model.backbone(x1), model.backbone(x2)
            paired = model.heads(torch.cat([f2, f1]))[2]
            alone = model.heads(torch.cat([f2, f2]))[2]
        gpu.reset_tracking()
        gpu.fields_batch(images[0][None])
        cached = gpu.fields_batch(images[1][None])[2]
    compare_heads([cached], [paired.cpu()], 'tracking cache')
    d_paired = float((cached - paired).abs().max())
    d_alone = float((cached - alone).abs().max())
    if not d_alone > 10.0 * d_paired:
        raise AssertionError(f"frame 2's Tcaf did not see frame 1: max abs "
                             f'diff {d_paired} to [frame 2, frame 1], '
                             f'{d_alone} to [frame 2, frame 2]')
    log(f'tracking (13a): frame 2\'s Tcaf is the heads on [frame 2, frame '
        f'1] (the cached features; max abs diff {d_paired:.2e}, to frame 2 '
        f'paired with itself {d_alone:.2e}); NN ms per frame (CUDA events, '
        f'TF32 off, the first includes warm-up) '
        f'{[round(t, 3) for t in nn_ms]} [{card}]')


def phase_tracking_golden(cifhr_cuda, device, card):
    """13b: the tracking golden file's frames through the port's tracking
    ``Multi`` (CifCaf and TrackingPose, CifHr 'auto': the kernel) on the
    card: each frame's annotations and track ids against JAX's, the CifHr
    launches per frame; then warm decode ms per frame and, from a profiled
    pass, device ops, stream syncs and device busy time per frame."""
    from torch_port_helpers import GOLDEN_STRIDE, TRACKING_GOLDEN, \
        assert_tracking_frame, port_tracking_decoder, reset_port_track_ids, \
        tracking_golden_fields

    golden = np.load(TRACKING_GOLDEN)
    frames = [[torch.from_numpy(f[None]).to(device) for f in fields]
              for fields in tracking_golden_fields(golden)]

    def sequence(step):
        reset_port_track_ids()
        multi = port_tracking_decoder(GOLDEN_STRIDE)
        return [step(multi, fields) for fields in frames]

    def checked(multi, fields):
        before = cifhr_cuda.LAUNCHES
        anns = multi.batch_decode(fields)[0]
        return anns, cifhr_cuda.LAUNCHES - before

    def timed(multi, fields):
        anns = multi.batch_decode(fields)[0]
        return anns, multi.last_decoder_time * 1e3

    def profiled(multi, fields):
        out = []
        stats = decode_profile(lambda: out.append(
            multi.batch_decode(fields)[0]))
        return out[0], stats

    first = sequence(checked)
    for t, (anns, launches) in enumerate(first):
        assert_tracking_frame(anns, golden[f'frame{t}_poses'],
                              golden[f'frame{t}_ids'], label=f'frame {t}')
        if launches == 0:
            raise AssertionError(f'tracking golden frame {t}: no CifHr '
                                 'kernel launch')
    warm = sequence(timed)
    for t, (anns, _) in enumerate(warm):
        assert_tracking_frame(anns, golden[f'frame{t}_poses'],
                              golden[f'frame{t}_ids'], label=f'frame {t}')
    prof = sequence(profiled)
    for t, ((anns, launches), (_, ms), (_, (ops, syncs, busy))) in \
            enumerate(zip(first, warm, prof)):
        ids = [a.id_ for a in anns if a.id_ is not None]
        log(f'tracking golden (13b) frame {t}: {len(anns)} annotations '
            f'match the JAX decode, track ids {ids}; {launches} CifHr '
            f'kernel launches; decode {ms:.2f} ms (second pass), {ops} '
            f'device ops, {syncs} stream syncs, device busy {busy:.3f} ms '
            f'(profiled pass) [{card}]')


def phase_video(port, device, card):
    """13c: ``openpifpaf_tpu_torch.video.main`` (the CLI's entry point) on
    the card with a random tshufflenetv2k16 tracking checkpoint saved by
    the port over VIDEO_FRAMES synthetic JPEGs of IMAGE_HW: one JSON line
    per frame; per-frame NN ms (CUDA events around ``fields_batch``),
    decode ms and peak memory, with the CifHr launches read around the
    run; then a second run with each decode profiled for its device busy
    time. Returns the first run's CifHr launches."""
    import tempfile
    import PIL.Image
    from openpifpaf_tpu_torch import __version__, decoder, video
    from openpifpaf_tpu_torch.predictor import Predictor
    from openpifpaf_tpu_torch.training import checkpoint
    from torch_port_helpers import restored_statics

    model = tracking_model()
    rng = np.random.RandomState(5)
    with tempfile.TemporaryDirectory() as directory:
        ckpt = os.path.join(directory, 'tshufflenetv2k16')
        checkpoint.save(ckpt, state_dict=model.state_dict(), meta={
            'base_name': 'tshufflenetv2k16', 'epoch': 0,
            'version': __version__,
            'head_metas': [checkpoint.headmeta_to_dict(m)
                           for m in model.head_metas]})
        names = []
        for i in range(VIDEO_FRAMES):
            names.append(os.path.join(directory, f'f{i}.jpg'))
            PIL.Image.fromarray(rng.randint(
                0, 256, IMAGE_HW + (3,), dtype=np.uint8)).save(names[-1])

        def run(label, profile):
            out = os.path.join(directory, label + '.jsonl')
            nn_ms, decode = [], []
            fields_batch = Predictor.fields_batch
            batch_decode = decoder.Multi.batch_decode

            def timed_fields(self, image_batch):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fields = fields_batch(self, image_batch)
                end.record()
                torch.cuda.synchronize()
                nn_ms.append(start.elapsed_time(end))
                return fields

            def measured_decode(self, fields):
                if not profile:
                    anns = batch_decode(self, fields)
                    decode.append(self.last_decoder_time * 1e3)
                    return anns
                anns = []
                decode.append(decode_profile(lambda: anns.append(
                    batch_decode(self, fields))))
                return anns[0]

            Predictor.fields_batch = timed_fields
            decoder.Multi.batch_decode = measured_decode
            gc.collect()
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            start = time.perf_counter()
            try:
                with restored_statics(*decoder.DECODERS, decoder.TrackBase):
                    video.main(['--source', ','.join(names), '--checkpoint',
                                ckpt, '--json-output', out, '--quiet'])
            finally:
                Predictor.fields_batch = fields_batch
                decoder.Multi.batch_decode = batch_decode
            wall = time.perf_counter() - start
            peak = torch.cuda.max_memory_allocated() - before
            with open(out) as f:
                lines = [json.loads(line) for line in f]
            if [line['frame'] for line in lines] != \
                    list(range(1, VIDEO_FRAMES + 1)) or any(
                        not isinstance(line['predictions'], list)
                        for line in lines):
                raise AssertionError(f'video {label}: JSON lines {lines}')
            return lines, nn_ms, decode, peak, wall

        reset_launches(port)
        lines, nn_ms, decode_ms, peak, wall = run('timed', False)
        launches = read_launches(port)['cifhr_accumulate']
        if launches == 0:
            raise AssertionError('the video CLI launched no CifHr kernel')
        _, _, profiles, _, _ = run('profiled', True)
    for i, (nn, ms, (ops, syncs, busy)) in enumerate(zip(nn_ms, decode_ms,
                                                         profiles)):
        log(f'video (13c) frame {i + 1}: NN {nn:.3f} ms (CUDA events), '
            f'decode {ms:.2f} ms, {len(lines[i]["predictions"])} '
            f'predictions; profiled run: {ops} device ops, {syncs} stream '
            f'syncs, device busy {busy:.3f} ms = {busy / ms:.3f} of the '
            f'unprofiled decode{" (first frame, warm-up)" if i == 0 else ""}'
            f' [{card}]')
    log(f'video (13c): {VIDEO_FRAMES} JSON lines with frame and predictions;'
        f' {launches} CifHr kernel launches; warm (frames 2-{VIDEO_FRAMES}) '
        f'median NN {np.median(nn_ms[1:]):.3f} ms, decode '
        f'{np.median(decode_ms[1:]):.2f} ms per frame; peak memory '
        f'{peak / 2 ** 30:.3f} GiB above what the process held; whole run '
        f'{wall:.1f} s [{card}]')
    return launches


def phase_tracking(port, device, card):
    """Phase 13: (a)-(c); returns the CifHr launches of (c)."""
    phase_tracking_forward(device, card)
    phase_tracking_golden(port.cifhr_cuda, device, card)
    return phase_video(port, device, card)


#: phase 14: PoseTrack eval over POSETRACK_SEQUENCES synthetic sequences of
#: POSETRACK_FRAMES frames at PoseTrack's usual 720x1280, at the default
#: --posetrack-eval-long-edge (801)
POSETRACK_SEQUENCES = 2
POSETRACK_FRAMES = 4
POSETRACK_HW = (720, 1280)
#: decoder thresholds lowered so that the fields give poses: the eval's
#: posetrack2018 heads do not match the checkpoint's cocokpst heads by
#: (dataset, name), so they are new, initialised from seed 0 (as in the
#: JAX package), with confidences near 0.5 everywhere; at the default
#: seed threshold (0.5) no pose comes out, at 0.1 the seed budget fills
POSETRACK_DECODER_FLAGS = ('--seed-threshold', '0.1', '--keypoint-threshold',
                           '0.01', '--instance-threshold', '0.0')
#: CifHr tiers each decoder runs per frame with these flags: the fast tier,
#: and the crowd tier because the seed budget fills; one launch each
POSETRACK_TIERS = 2


def tracking_train_batch(data):
    """One batch of the port's cocokpst pipeline (augmentation on: 4
    pairs, 8 interleaved frames at 385 px), its head metas and the
    full-width tshufflenetv2k16 (random, seed 0)."""
    from openpifpaf_tpu_torch.datasets import factory
    from openpifpaf_tpu_torch.plugins.coco.cocokp import CocoKp
    from torch_port_helpers import restored_statics

    ann_file, image_dir = data
    with restored_statics(CocoKp):
        CocoKp.train_annotations, CocoKp.train_image_dir = ann_file, image_dir
        CocoKp.square_edge = TRAIN_EDGE
        datamodule = factory('cocokpst')
        datamodule.batch_size = TRAIN_BATCH
        model = tracking_model(datamodule.head_metas)
        np.random.seed(TRAIN_SEED)
        images, targets, metas = next(iter(datamodule.train_loader()))
    if images.shape != (TRAIN_BATCH, TRAIN_EDGE, TRAIN_EDGE, 3) \
            or len(targets) != 3 or len(metas) != TRAIN_BATCH // 2 \
            or any(t.shape[0] != TRAIN_BATCH // 2 for t in targets):
        raise AssertionError(f'cocokpst batch {images.shape}, targets '
                             f'{[t.shape for t in targets]}, {len(metas)} '
                             'metas')
    return images, targets, datamodule.head_metas, model


def phase_tracking_train(data, directory, device, card):
    """14a-b: one cocokpst step on the card against the CPU's
    (:func:`phase_train_step`), then ``train.main --dataset cocokpst
    --basenet tshufflenetv2k16`` at the JAX defaults (:func:`train_run`);
    ``load_shell`` reads its checkpoint as a TrackingShell with the
    trainer's EMA weights. Returns the checkpoint."""
    from openpifpaf_tpu_torch.models.tracking import TrackingShell
    from openpifpaf_tpu_torch.training import checkpoint

    batch = tracking_train_batch(data)
    phase_train_step(batch, device, card, label='tracking train step (14a)')
    out = os.path.join(directory, 'cocokpst', 'model')
    trainer = train_run(train_flags(data, out, '--dataset', 'cocokpst',
                                    '--basenet', 'tshufflenetv2k16'),
                        out, 'tracking train run (14b) float32', card)
    model, meta = checkpoint.load_shell(out)
    written = trainer.ema_state_dict()
    if not (isinstance(model, TrackingShell)
            and meta['base_name'] == 'tshufflenetv2k16'
            and all(torch.equal(v, written[k])
                    for k, v in model.state_dict().items())):
        raise AssertionError(f'load_shell({out}): {type(model).__name__}, '
                             f'{meta["base_name"]}')
    log(f'tracking train run (14b): load_shell reads {out} as a '
        f'TrackingShell with the trainer\'s EMA weights, heads '
        f'{[type(m).__name__ for m in model.head_metas]}')
    profile_train_step(trainer, batch, 'tracking train run (14b) float32',
                       card)
    return out


def phase_posetrack_eval(port, ckpt, directory, card):
    """14c: ``openpifpaf_tpu_torch.eval.main`` (in-process, on the card)
    ``--dataset posetrack2018 --write-predictions`` with 14b's checkpoint
    over synthetic PoseTrack 2018 sequences, at batch 1 and the default
    long edge: per frame the CifHr launches of CifCaf and of TrackingPose
    (read through the launch counter around each decoder), NN ms (CUDA
    events) and each decoder's ms; ``eval_reset`` emitted once, when the
    second sequence's first frame is pulled; the stats and one prediction
    JSON per sequence. Each decoder must launch the kernel once per tier
    it ran, POSETRACK_TIERS times per frame. The cells of every CifHr call
    of the run are kept, and the kernel on them is held bit for bit
    against its plain version at the eval's map shape. Returns the run's
    CifHr launches (the comparison's launches come after and are not
    counted)."""
    from openpifpaf_tpu_torch import decoder, eval_cli
    from openpifpaf_tpu_torch.plugins.coco.cocokp import CocoKp
    from openpifpaf_tpu_torch.plugins.posetrack.cocokpst import CocoKpSt
    from openpifpaf_tpu_torch.plugins.posetrack.posetrack2017 import \
        Posetrack2017
    from openpifpaf_tpu_torch.plugins.posetrack.posetrack2018 import \
        Posetrack2018
    from openpifpaf_tpu_torch.predictor import Predictor
    from openpifpaf_tpu_torch.signal_ import Signal
    from torch_port_helpers import restored_statics, \
        write_synthetic_posetrack2018

    _, val_glob, root = write_synthetic_posetrack2018(
        os.path.join(directory, 'posetrack'), n_sequences=POSETRACK_SEQUENCES,
        n_frames=POSETRACK_FRAMES, image_hw=POSETRACK_HW, seed=0)
    frames = []
    resets = []
    fields_batch = Predictor.fields_batch
    batch_decode = decoder.Multi.batch_decode
    cifhr_cuda = port.cifhr_cuda
    accumulate = cifhr_cuda.accumulate
    calls = []

    def timed_fields(self, image_batch):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fields = fields_batch(self, image_batch)
        end.record()
        torch.cuda.synchronize()
        frames.append({'nn_ms': start.elapsed_time(end),
                       'shape': tuple(image_batch.shape)})
        return fields

    def counted(dec):
        inner = dec.batch_decode

        def per_decoder(fields):
            before = cifhr_cuda.LAUNCHES
            out = inner(fields)
            tiers = 1 + len(getattr(dec, 'pose_generator', dec).last_escalated)
            frames[-1][type(dec).__name__] = (
                cifhr_cuda.LAUNCHES - before, dec.last_decoder_time * 1e3,
                tiers)
            return out
        return per_decoder

    def kept(x, y, sigma, w, **kw):
        calls.append(((x.clone(), y.clone(), sigma.clone(), w.clone()), kw))
        return accumulate(x, y, sigma, w, **kw)

    def counted_decode(self, fields):
        for dec in self.decoders:
            if 'batch_decode' not in vars(dec):
                dec.batch_decode = counted(dec)
        return batch_decode(self, fields)

    out = os.path.join(directory, 'posetrack-eval')
    subscribers = list(Signal.subscribers.get('eval_reset', []))
    Signal.subscribe('eval_reset', lambda: resets.append(len(frames)))
    Predictor.fields_batch = timed_fields
    decoder.Multi.batch_decode = counted_decode
    cifhr_cuda.accumulate = kept
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(port)
    t0 = time.perf_counter()
    try:
        with restored_statics(*decoder.DECODERS, decoder.TrackBase, CocoKp,
                              CocoKpSt, Posetrack2018, Posetrack2017,
                              eval_cli.Evaluator):
            eval_cli.main(['--dataset', 'posetrack2018', '--checkpoint', ckpt,
                           '--posetrack2018-eval-annotations', val_glob,
                           '--posetrack2018-data-root', root,
                           '--write-predictions', '--eval-loader-warmup',
                           '0', '--output', out, *POSETRACK_DECODER_FLAGS])
    finally:
        Predictor.fields_batch = fields_batch
        decoder.Multi.batch_decode = batch_decode
        cifhr_cuda.accumulate = accumulate
        Signal.subscribers['eval_reset'] = subscribers
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - before
    launches = read_launches(port)['cifhr_accumulate']

    n_frames = POSETRACK_SEQUENCES * POSETRACK_FRAMES
    with open(out + '.stats.json') as f:
        stats = json.load(f)
    files = sorted(os.listdir(out))
    if not (len(frames) == stats['n_images'] == n_frames
            and stats['nn_time'] > 0 and stats['decoder_time'] > 0
            and stats['stats'][0] == n_frames):
        raise AssertionError(f'posetrack eval: {len(frames)} frames, stats '
                             f'{stats}')
    if resets != [POSETRACK_FRAMES]:
        raise AssertionError(f'posetrack eval: eval_reset after frames '
                             f'{resets}, want once after frame '
                             f'{POSETRACK_FRAMES}')
    names = ('CifCaf', 'TrackingPose')
    for i, frame in enumerate(frames):
        got = [frame.get(name, (0, 0, 0)) for name in names]
        if any(g[0] != g[2] or g[2] != POSETRACK_TIERS for g in got):
            raise AssertionError(f'posetrack eval frame {i}: (CifHr '
                                 'launches, ms, tiers) per decoder '
                                 f'{frame}, want {POSETRACK_TIERS} tiers '
                                 'and one launch per tier')
    want = len(names) * POSETRACK_TIERS * n_frames
    if not launches == len(calls) == want:
        raise AssertionError(f'posetrack eval: {launches} CifHr launches, '
                             f'{len(calls)} calls, want {want}')
    hr_shapes = set()
    for i, (cells, kw) in enumerate(calls):
        kernel = cifhr_cuda.accumulate(*cells, **kw)
        plain = port.cifhr.accumulate_dense(*cells, **kw)
        if not torch.equal(kernel, plain):
            raise AssertionError(
                f'posetrack eval CifHr call {i} at {tuple(kernel.shape)}: '
                'kernel vs plain not bit-equal, max abs err '
                f'{float((kernel - plain).abs().max())}')
        hr_shapes.add((*kernel.shape, cells[0].shape[1]))
    if len(files) != POSETRACK_SEQUENCES:
        raise AssertionError(f'posetrack eval: prediction files {files}')
    predictions = []
    for name in files:
        with open(os.path.join(out, name)) as f:
            data = json.load(f)
        if len(data['images']) != POSETRACK_FRAMES:
            raise AssertionError(f'{name}: {len(data["images"])} images')
        predictions.append(len(data['annotations']))
    for i, frame in enumerate(frames):
        log(f'posetrack eval (14c) frame {i}: image {frame["shape"]}, NN '
            f'{frame["nn_ms"]:.3f} ms (CUDA events); CifCaf '
            f'{frame["CifCaf"][0]} CifHr launches, {frame["CifCaf"][1]:.2f} '
            f'ms; TrackingPose {frame["TrackingPose"][0]} CifHr launches, '
            f'{frame["TrackingPose"][1]:.2f} ms [{card}]')
    per_image = {k: stats[k] / n_frames * 1e3
                 for k in ('total_time', 'nn_time', 'decoder_time')}
    log(f'posetrack eval (14c): {n_frames} frames of {POSETRACK_HW} in '
        f'{POSETRACK_SEQUENCES} sequences, eval_reset once (after frame '
        f'{resets[0]}), {launches} CifHr kernel launches; per frame (stats,'
        f' the first included) total {per_image["total_time"]:.2f} ms, nn '
        f'{per_image["nn_time"]:.2f} ms, decoder '
        f'{per_image["decoder_time"]:.2f} ms; warm (frames 2-) median NN '
        f'{np.median([f["nn_ms"] for f in frames[1:]]):.3f} ms, decode '
        f'{np.median([sum(f[n][1] for n in names) for f in frames[1:]]):.2f}'
        f' ms; {files} with {predictions} predictions (stats '
        f'{stats["stats"]}); peak memory {peak / 2 ** 30:.3f} GiB above '
        f'what the process held; whole command {wall:.1f} s [{card}]')
    log(f'posetrack eval (14c): the kernel on the cells of all {len(calls)} '
        'CifHr calls equals its plain version bit for bit at (F, hr_h, '
        f'hr_w, K) {sorted(hr_shapes)}')
    return launches


def phase_tracking_training(port, device, card):
    """Phase 14: (a)-(c) on a synthetic COCO set; returns the CifHr
    launches of (c)."""
    import tempfile
    from torch_port_helpers import write_synthetic_coco

    with tempfile.TemporaryDirectory() as directory:
        data = write_synthetic_coco(os.path.join(directory, 'coco'),
                                    n_images=TRAIN_IMAGES,
                                    image_hw=TRAIN_IMAGE_HW, seed=TRAIN_SEED)
        ckpt = phase_tracking_train(data, directory, device, card)
        return phase_posetrack_eval(port, ckpt, directory, card)


def kernel_entry(name, source, replaces, launches, rows, row):
    """One kernel's entry of the JSON line: times and bound of ``row``,
    the largest error of all ``rows``."""
    return {
        'name': name,
        'route': 'cuda',
        'source': f'openpifpaf_tpu_torch/csrc/{source}',
        'replaces': replaces,
        'launches': launches,
        'max_abs_err': max(r['err'] for r in rows),
        'ms': row['ms'],
        'plain_ms': row['plain_ms'],
        'bound_ms': row['bound_ms'],
        'bound_by': row['bound_by'],
        'library_ms': row['library_ms'],
        'device_ms': row['device_ms'],
        'library_device_ms': row.get('library_device_ms'),
    }


def main():
    if not torch.cuda.is_available():
        sys.stderr.write('chip_smoke.py needs a CUDA device\n')
        sys.exit(2)
    device = torch.device('cuda:0')
    card = card_line()
    log(card)
    log(f'torch {torch.__version__} cuda {torch.version.cuda} on '
        f'{torch.cuda.get_device_name(0)}')

    port = import_port()
    phase_build(port)
    start_profiler()
    cifhr_rows = phase_kernel(port.cifhr, port.cifhr_cuda, device, card)
    backbone_results = phase_backbone_kernels(port, device, card)
    phase_golden(port.cifhr_cuda, device, card)
    phase_configs(port.cifhr_cuda, device, card)
    predictor, cifhr_launches = phase_main_path(port, device, card)
    launches, predictors = phase_engines(port, predictor, device, card)
    launches['cifhr_accumulate'] = cifhr_launches
    launches['shuffle_branch2'] = phase_branch2(port, predictor, device,
                                                card)
    phase_profile(predictors, device, card)
    lab_results = phase_lab_kernels(port, device, card)
    launches.update(phase_lab(port, card))
    phase_train(port, device, card)
    launches['cifhr_accumulate'] += phase_other_backbones(port, device, card)
    launches['cifhr_accumulate'] += phase_tracking(port, device, card)
    launches['cifhr_accumulate'] += phase_tracking_training(port, device,
                                                            card)

    # no single PyTorch call computes the CifHr map; times at F=17 K=256
    entries = [kernel_entry('cifhr_accumulate', 'cifhr.cu',
                            'openpifpaf_tpu/ops/cifhr_pallas.py:53',
                            launches['cifhr_accumulate'], cifhr_rows,
                            cifhr_rows[0])]
    replaces = {
        'depthwise_conv': ('depthwise.cu', 'models/dw_pallas.py:38'),
        'shuffle_block': ('shuffle_block.cu', 'models/shuffle_pallas.py:108'),
        'shuffle_branch2': ('shuffle_block.cu', 'models/block_pallas.py:119'),
    }
    for name, (source, tpu) in replaces.items():
        rows = backbone_results[name]
        # times at the first stage's shape in float32
        entries.append(kernel_entry(name, source, f'openpifpaf_tpu/{tpu}',
                                    launches[name], rows, rows[0]))
    lab_replaces = {'lab_interleave': 56, 'lab_dw_valid': 84,
                    'lab_branch2': 124}
    for name, line in lab_replaces.items():
        rows = lab_results[name]
        # times at the lab's first stage in bfloat16, as the lab runs
        row = rows[len(port.mosaic_lab.STAGES)]
        entries.append(kernel_entry(name, LAB_SYMBOLS[name][0],
                                    f'tools/mosaic_lab.py:{line}',
                                    launches[name], rows, row))
    log(json.dumps({'kernels': entries}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu',
        'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count(),
    }}))


if __name__ == '__main__':
    main()
