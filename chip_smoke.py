"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (non-zero exit):

1. device: a CUDA device is required; prints the card's name and power
   limit as nvidia-smi reports them;
2. build: compiles the CifHr kernel (``openpifpaf_tpu_torch/csrc/cifhr.cu``)
   from the sources next to this script;
3. kernel vs plain: ``cifhr_cuda.accumulate`` against its plain PyTorch
   version on seeded random cells at the decode's shapes, atol 1e-5, with
   both times from CUDA events;
4. golden decode: ``CifCaf.batch_decode`` on the fields of
   ``tests/golden/torch_decode_golden.npz`` (written with the JAX package)
   must give the stored JAX poses within the tie-free parity gate, go
   through the kernel and escalate the 40-person scene to the crowd tier;
   then each scene's warm batch-1 decode time;
5. main path: a full-width shufflenetv2k16 cocokp ``Predictor`` (random
   weights from seed 0) answers three single-image requests and one batch
   of two 481x641 images, with field shapes and values checked, and the
   kernel launch count read around that run; each request's end-to-end,
   NN and decode time per image.

The second-to-last line is a JSON object describing the kernels, the last
``{"ok": true, "device": {...}}``.
"""

import functools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, 'tests', 'golden', 'torch_decode_golden.npz')
KERNEL_ATOL = 1e-5
#: (n_fields, n_cells): COCO-17 at the fast and crowd tiers, wholebody-133
KERNEL_SHAPES = ((17, 256), (17, 1024), (133, 256))
HR_SHAPE = (513, 641)
IMAGE_HW = (481, 641)
#: fields at stride 16 of IMAGE_HW after the Predictor's bucket pad to 513x641
FIELD_HW = (33, 41)


def log(*args):
    print(*args, flush=True)


def card_line():
    done = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    return done.stdout.strip().splitlines()[0]


def import_port():
    """The port and the test helpers (pose gate, seeded cells) of this
    checkout."""
    sys.path[:0] = [ROOT, os.path.join(ROOT, 'tests')]
    import openpifpaf_tpu_torch
    if not os.path.abspath(openpifpaf_tpu_torch.__file__).startswith(ROOT):
        raise RuntimeError('openpifpaf_tpu_torch imported from '
                           f'{openpifpaf_tpu_torch.__file__}, not {ROOT}')
    from openpifpaf_tpu_torch.ops import cifhr, cifhr_cuda
    return cifhr, cifhr_cuda


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


def kernel_device_ms(calls, n):
    """Device time per launch of the CifHr kernel alone, for each of
    ``calls``, from one profiler session (a wrapper call also costs host
    time, which the CUDA-event loop of :func:`cuda_ms` sees when the kernel
    is short). None for all when the profiler did not record exactly ``n``
    kernels per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in calls:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA
                      and 'cifhr_kernel' in e.name),
                     key=lambda e: e.time_range.start)
    if len(kernels) != n * len(calls):
        return [None] * len(calls)
    return [sum(e.time_range.elapsed_us() for e in kernels[i:i + n]) / 1e3 / n
            for i in range(0, len(kernels), n)]


def phase_kernel(cifhr, cifhr_cuda, device, card):
    from torch_port_helpers import random_cells

    kw = dict(hr_h=HR_SHAPE[0], hr_w=HR_SHAPE[1])
    calls = []
    results = {}
    for n_fields, n_cells in KERNEL_SHAPES:
        cells = random_cells(n_fields, n_cells, *HR_SHAPE,
                             seed=n_fields + n_cells, device=device)
        kernel = cifhr_cuda.accumulate(*cells, **kw)
        plain = cifhr.accumulate_dense(*cells, **kw)
        torch.cuda.synchronize()
        err = float((kernel - plain).abs().max())
        if not err <= KERNEL_ATOL:
            raise AssertionError(f'CifHr kernel vs plain at {n_fields}x'
                                 f'{n_cells}: max abs err {err}')
        call = functools.partial(cifhr_cuda.accumulate, *cells, **kw)
        ms = cuda_ms(call, 50)
        plain_ms = cuda_ms(lambda: cifhr.accumulate_dense(*cells, **kw), 3)
        calls.append(call)
        results[(n_fields, n_cells)] = (err, ms, plain_ms)

    device_ms = kernel_device_ms(calls, 20)
    for ((n_fields, n_cells), (err, ms, plain_ms)), alone in zip(
            results.items(), device_ms):
        alone = 'not measured' if alone is None else f'{alone:.4f} ms'
        log(f'kernel F={n_fields} K={n_cells} map={HR_SHAPE}: max_abs_err '
            f'{err} (atol {KERNEL_ATOL}), kernel {ms:.4f} ms per call '
            f'(device time alone {alone}), plain {plain_ms:.3f} ms [{card}]')
    return results


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


def phase_main_path(cifhr_cuda, device, card):
    from openpifpaf_tpu_torch.predictor import Predictor

    predictor = Predictor(device=device)
    check_fields_against_cpu(predictor, device)

    rng = np.random.RandomState(0)
    requests = [[rng.randint(0, 256, IMAGE_HW + (3,), dtype=np.uint8)]
                for _ in range(3)]
    requests.append([rng.randint(0, 256, IMAGE_HW + (3,), dtype=np.uint8)
                     for _ in range(2)])

    seen = []
    fields_batch = predictor.fields_batch

    def recording_fields_batch(image_batch):
        fields = fields_batch(image_batch)
        seen.append([(tuple(f.shape), bool(torch.isfinite(f).all()))
                     for f in fields])
        return fields

    predictor.fields_batch = recording_fields_batch
    timings = []
    cifhr_cuda.LAUNCHES = 0
    for images in requests:
        predictor.batch_size = len(images)
        start = time.perf_counter()
        out = list(predictor.numpy_images(images))
        e2e = time.perf_counter() - start
        if len(out) != len(images):
            raise AssertionError(f'{len(out)} answers for {len(images)}')
        timings.append((len(images), e2e, predictor.last_nn_time,
                        predictor.last_decoder_time,
                        predictor.processor.last_escalated,
                        [len(pred) for pred, _, _ in out]))
    launches = cifhr_cuda.LAUNCHES
    if launches == 0:
        raise AssertionError('main path never launched the CifHr kernel')

    for (b, *_), shapes in zip(timings, seen):
        want = [((b, 17, 5) + FIELD_HW, True), ((b, 19, 8) + FIELD_HW, True)]
        if shapes != want:
            raise AssertionError(f'fields {shapes}, want {want}')
    for i, (b, e2e, nn_s, dec_s, escalated, n_anns) in enumerate(timings):
        log(f'request {i} batch {b}: e2e {e2e / b * 1e3:.2f} ms/image, '
            f'NN {nn_s / b * 1e3:.2f} ms/image, '
            f'decode {dec_s / b * 1e3:.2f} ms/image, crowd tier for '
            f'{escalated}, annotations {n_anns}'
            f'{" (first call, warm-up)" if i == 0 else ""} [{card}]')
    log(f'main path: {launches} CifHr kernel launches')
    return launches


def main():
    if not torch.cuda.is_available():
        sys.stderr.write('chip_smoke.py needs a CUDA device\n')
        sys.exit(2)
    device = torch.device('cuda:0')
    card = card_line()
    log(card)
    log(f'torch {torch.__version__} cuda {torch.version.cuda} on '
        f'{torch.cuda.get_device_name(0)}')

    cifhr, cifhr_cuda = import_port()
    start = time.perf_counter()
    log(f'built {cifhr_cuda.build()} in '
        f'{time.perf_counter() - start:.1f} s')

    kernel_results = phase_kernel(cifhr, cifhr_cuda, device, card)
    phase_golden(cifhr_cuda, device, card)
    launches = phase_main_path(cifhr_cuda, device, card)

    _, ms, plain_ms = kernel_results[(17, 256)]
    log(json.dumps({'kernels': [{
        'name': 'cifhr_accumulate',
        'route': 'cuda',
        'source': 'openpifpaf_tpu_torch/csrc/cifhr.cu',
        'replaces': 'openpifpaf_tpu/ops/cifhr_pallas.py:53',
        'launches': launches,
        'max_abs_err': max(r[0] for r in kernel_results.values()),
        'ms': ms,
        'plain_ms': plain_ms,
    }]}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu',
        'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count(),
    }}))


if __name__ == '__main__':
    main()
