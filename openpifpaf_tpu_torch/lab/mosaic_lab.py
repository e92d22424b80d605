"""Microbenchmarks of the fused-block design's primitives on the card, at
k16's stage geometries (the port of ``tools/mosaic_lab.py``):

  interleave  : lane interleave (channel_shuffle's core), CUDA kernel vs
                ``torch.stack``
  dw          : VALID 5x5 depthwise (the depthwise kernel's VALID mode) vs
                cuDNN's grouped conv
  branch2     : the repeat block's branch2 (1x1, dw 5x5, 1x1; the fused
                block kernel's lab mode) vs its plain version (cuDNN's
                three convs), with useful TFLOP/s and the relative
                difference between the two
  branch2_xla : the plain version alone
  rtile       : the branch2 kernel at tile rows 8, 16, 24, 32 and 40; a
                height for which no launch plan fits (the kernel's strips
                hold at most 8 rows) is reported, not run

Usage (needs a CUDA device; the default names are ``dw branch2``):

    python -m openpifpaf_tpu_torch.lab.mosaic_lab [names...]

Every line ends with the card's name and power limit from ``nvidia-smi``.
"""

import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

from . import kernels
from .timing import time_op

# k16 stage geometries: (H, W, half_channels)
STAGES = {
    'stage2': (121, 161, 174),
    'stage3': (61, 81, 348),
    'stage4': (31, 41, 696),
}
NAMES = ('interleave', 'dw', 'branch2', 'branch2_xla')
RTILES = (8, 16, 24, 32, 40)


def _rng(*shape):
    return np.random.RandomState(0).randn(*shape).astype(np.float32)


def card_line():
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    done = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    return done.stdout.strip().splitlines()[0]


def _line(text, card):
    print(f'{text} [{card}]', flush=True)


def bench_interleave(name, h, w, c, *, card, device, dtype=torch.bfloat16):
    t = kernels.from_lab_arrays(dtype, device, a=_rng(h, w, c),
                                b=_rng(h, w, c))
    kernel = time_op(lambda: kernels.lane_interleave(t['a'], t['b']))
    _line(f'{name} interleave cuda  : {kernel * 1e6:9.1f} us', card)
    library = time_op(lambda: kernels.lane_interleave_plain(t['a'], t['b']))
    _line(f'{name} interleave stack : {library * 1e6:9.1f} us', card)
    return dict(stage=name, op='interleave', kernel_s=kernel,
                library_s=library)


def bench_dw(name, h, w, c, *, card, device, k=5, dtype=torch.bfloat16):
    pad = k // 2
    t = kernels.from_lab_arrays(dtype, device,
                                x=_rng(h + 2 * pad, w + 2 * pad, c),
                                wt=_rng(k, k, c))
    kernel = time_op(lambda: kernels.dw_valid(t['x'], t['wt']))
    _line(f'{name} dw5x5 cuda       : {kernel * 1e6:9.1f} us', card)
    library = time_op(lambda: F.conv2d(t['x'], t['wt'], groups=c))
    _line(f'{name} dw5x5 cudnn conv : {library * 1e6:9.1f} us', card)
    return dict(stage=name, op='dw', kernel_s=kernel, library_s=library)


def branch2_inputs(h, w, c, *, device, k=5, dtype=torch.bfloat16):
    """The lab's branch2 inputs (``_rng``, the halo real data), unpadded:
    x2 (1, C, H + 2h, W + 2h) and :class:`kernels.Branch2Weights`."""
    pad = k // 2
    t = kernels.from_lab_arrays(
        dtype, device, x2=_rng(h + 2 * pad, w + 2 * pad, c), w1=_rng(c, c),
        b1=_rng(c), wd=_rng(k, k, c), bd=_rng(c), w3=_rng(c, c), b3=_rng(c))
    x2 = t.pop('x2')
    return x2, kernels.Branch2Weights(**t)


def _useful_tflops(h, w, c, seconds):
    return 2 * h * w * c * c * 2 / seconds / 1e12


def bench_branch2(name, h, w, c, *, card, device, k=5, dtype=torch.bfloat16,
                  r_tile=None):
    x2, weights = branch2_inputs(h, w, c, device=device, k=k, dtype=dtype)
    r_tile = kernels.branch2_plan(1, h, w, c, k=k, dtype=dtype,
                                  r_tile=r_tile).th
    out = kernels.branch2(x2, weights, r_tile=r_tile).float()
    expect = kernels.branch2_plain(x2, weights).float()
    rel = float((out - expect).abs().max()) / max(
        float(expect.abs().max()), 1e-6)
    kernel = time_op(lambda: kernels.branch2(x2, weights, r_tile=r_tile))
    _line(f'{name} branch2 cuda     : {kernel * 1e6:9.1f} us '
          f'({_useful_tflops(h, w, c, kernel):.1f} TFLOP/s useful, rtile '
          f'{r_tile}, rel diff {rel:.1e})', card)
    library = bench_branch2_xla(name, h, w, c, card=card, device=device, k=k,
                                dtype=dtype, inputs=(x2, weights))
    return dict(stage=name, op='branch2', kernel_s=kernel, library_s=library,
                rel_diff=rel, r_tile=r_tile)


def bench_branch2_xla(name, h, w, c, *, card, device, k=5,
                      dtype=torch.bfloat16, inputs=None):
    """The plain version of branch2 (cuDNN's three convs), timed."""
    x2, weights = inputs or branch2_inputs(h, w, c, device=device, k=k,
                                           dtype=dtype)
    t = time_op(lambda: kernels.branch2_plain(x2, weights))
    _line(f'{name} branch2 plain    : {t * 1e6:9.1f} us '
          f'({_useful_tflops(h, w, c, t):.1f} TFLOP/s useful)', card)
    return t


def bench_rtile(name, h, w, c, *, card, device, k=5, dtype=torch.bfloat16):
    results = []
    for rt in RTILES:
        if rt > h:
            continue
        try:
            kernels.branch2_plan(1, h, w, c, k=k, dtype=dtype, r_tile=rt)
        except ValueError as e:
            _line(f'{name} rtile {rt}: does not fit, {e}', card)
            continue
        results.append(bench_branch2(name, h, w, c, card=card, device=device,
                                     k=k, r_tile=rt))
    return results


def main(argv=None):
    """Run the named benchmarks at every stage; returns one dict per
    timed kernel (times in seconds)."""
    names = list(sys.argv[1:] if argv is None else argv) or ['dw', 'branch2']
    unknown = [n for n in names if n not in NAMES
               and not n.startswith('rtile')]
    if unknown:
        raise SystemExit(f'unknown lab names {unknown}; known: '
                         f'{list(NAMES)} and rtile')
    if not torch.cuda.is_available():
        raise SystemExit('openpifpaf_tpu_torch.lab.mosaic_lab times CUDA '
                         'kernels and needs a CUDA device; none is '
                         'available')
    device = torch.device('cuda', torch.cuda.current_device())
    card = card_line()
    kw = dict(card=card, device=device)
    results = []
    for stage, (h, w, c) in STAGES.items():
        for n in names:
            if n == 'interleave':
                results.append(bench_interleave(stage, h, w, c, **kw))
            elif n == 'dw':
                results.append(bench_dw(stage, h, w, c, **kw))
            elif n == 'branch2':
                results.append(bench_branch2(stage, h, w, c, **kw))
            elif n == 'branch2_xla':
                bench_branch2_xla(stage, h, w, c, **kw)
            else:
                results.extend(bench_rtile(stage, h, w, c, **kw))
    return results


if __name__ == '__main__':
    main()
