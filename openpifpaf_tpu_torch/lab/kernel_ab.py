"""A/B of the port's kernels against the sources of an earlier commit, on
one card, in one process, and a sweep of the CifHr kernel's launch plans:

    python -m openpifpaf_tpu_torch.lab.kernel_ab OLD_ROOT [CASE ...]

``CASE`` is a kernel: ``depthwise_conv``, ``shuffle_block``,
``shuffle_branch2``, ``lab_dw_valid``, ``lab_branch2``, ``cifhr`` or
``cifhr_plans``; without one, every case but ``cifhr_plans``. ``OLD_ROOT``
is an unpacked earlier commit of the repo (for example ``git archive
32bd13f | tar -x -C .chipwork/old``) whose ``openpifpaf_tpu_torch/csrc``
has these C interfaces, each built only for the cases that use it:

- ``depthwise.cu``: ``depthwise_conv(dtype, x, w, b, out, n, h, w, c, k,
  dilation, act, vec, nv, groups, tw, strips, threads, smem, stream)``,
  'SAME' only (as of ``32bd13f``; this checkout adds ``valid`` after
  ``dtype``);
- ``shuffle_block.cu``: ``shuffle_block(dtype, interleave, x, w1, b1, wdw,
  bdw, w3, b3, out, n, h, w, cb, k, dilation, act, th, tw, cluster, slice,
  vb, smem, stream)`` (as of ``32bd13f``; this checkout's modes 1 and 0);
- ``mosaic_lab.cu``: the lab's own kernels ``lab_dw_valid(dtype, x, w, out,
  n, h, w, c, k, stream)`` and ``lab_branch2(dtype, x2, w1, b1, wd, bd, w3,
  b3, out, n, h, w, c, k, r_tile, stream)``, run at 4 tile rows (as of
  ``32bd13f``);
- ``cifhr.cu``: ``cifhr_accumulate(x, y, sigma, w_scaled, out, F, K, H, W,
  stream)`` (up to ``a7de7e9``), its weights scaled by the caller
  as its wrapper did (two elementwise ops, not timed).

Both versions are built with this checkout's nvcc flags, and the backbone
kernels of both run with this checkout's launch plans (``dw_cuda.plan``,
``shuffle_cuda.plan``).

Cases: the depthwise conv and both modes of the fused block at k16's three
stage shapes for a 513x641 input; the lab's VALID depthwise conv and
branch2 at the lab's three stages (``mosaic_lab.STAGES``), against this
checkout's VALID and lab modes of the same kernels, each in float32 and
bfloat16 (TF32 off); CifHr in float32 on the decode's 513x641 map, at (F,
K) = (17, 256), (17, 1024) and (133, 256) on seeded random cells and on
the golden file's sparse and crowd cells at both tiers' budgets. Both
versions are checked against the plain version (float32 1e-5, absolute
for the backbone kernels and of the largest output for the lab's, bit for
bit for CifHr; bfloat16 one rounding step of the largest output), then
each version's device time alone per call is taken from ``torch.profiler``
(20 back-to-back calls), and its call time (host included) from CUDA
events, in turns: old, new, new, old. ``cifhr_plans``
times this checkout's CifHr kernel under a grid of launch plans on the
same CifHr cases (it builds nothing from ``OLD_ROOT``). It prints one line
per case, the card's ``nvidia-smi`` name and power limit, and a JSON line
of the results. It needs a CUDA device."""

import ctypes
import dataclasses
import functools
import json
import os
import subprocess
import sys

import torch

from .. import _nvcc
from ..models import block_cuda, dw_cuda, shuffle_cuda
from ..models.dw_cuda import DTYPES, alignment
from ..ops import cifhr, cifhr_cuda
from . import kernels as lab_kernels
from .mosaic_lab import STAGES as LAB_STAGES
from .timing import device_ms

#: (Cb, H, W) of shufflenetv2k16's stages 2-4 for a 513x641 input
STAGES = ((174, 129, 161), (348, 65, 81), (696, 33, 41))
CALLS = 20
#: the backbone and lab kernels' cases, and every case name
BACKBONE_CASES = ('depthwise_conv', 'shuffle_block', 'shuffle_branch2',
                  'lab_dw_valid', 'lab_branch2')
CASES = BACKBONE_CASES + ('cifhr', 'cifhr_plans')
BACKBONE_SYMBOLS = {'depthwise_conv': 'depthwise_kernel',
                    'shuffle_block': 'shuffle_block_kernel',
                    'shuffle_branch2': 'shuffle_block_kernel'}
#: (F, K) of the CifHr cases: COCO-17 at the fast and crowd tiers,
#: wholebody-133, on the decode's map at 641px
CIFHR_SHAPES = ((17, 256), (17, 1024), (133, 256))
CIFHR_HW = (513, 641)
#: the old lab branch2 kernel's tile rows (its default)
OLD_LAB_R_TILE = 4
_OLD_ARGS = {
    'depthwise_conv': ([ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 14 + [ctypes.c_void_p]),
    'shuffle_block': ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
                      + [ctypes.c_int] * 13 + [ctypes.c_void_p]),
    'lab_dw_valid': ([ctypes.c_int] + [ctypes.c_void_p] * 3
                     + [ctypes.c_int] * 5 + [ctypes.c_void_p]),
    'lab_branch2': ([ctypes.c_int] + [ctypes.c_void_p] * 8
                    + [ctypes.c_int] * 6 + [ctypes.c_void_p]),
    'cifhr_accumulate': ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                         + [ctypes.c_void_p]),
}


def _old_function(old_root, source, symbol):
    lib = ctypes.CDLL(_nvcc.build(
        source, os.path.join(old_root, 'openpifpaf_tpu_torch', 'csrc')))
    fn = getattr(lib, symbol)
    fn.argtypes = _OLD_ARGS[symbol]
    fn.restype = ctypes.c_int
    return fn


def _empty(x, c, h, w):
    return torch.empty((x.shape[0], c, h, w), dtype=x.dtype, device=x.device,
                       memory_format=torch.channels_last)


def old_calls(old_root):
    """The earlier kernels as functions of the new wrappers' arguments:
    the depthwise conv, the fused block, the lab's dw and branch2."""
    dw = _old_function(old_root, 'depthwise.cu', 'depthwise_conv')
    block = _old_function(old_root, 'shuffle_block.cu', 'shuffle_block')
    lab_dw = _old_function(old_root, 'mosaic_lab.cu', 'lab_dw_valid')
    lab_b2 = _old_function(old_root, 'mosaic_lab.cu', 'lab_branch2')

    def depthwise(x, kernel, bias, *, dilation=1, act=True, leaky=False):
        n, c, h, w = x.shape
        out = _empty(x, c, h, w)
        k = kernel.shape[-1]
        p = dw_cuda.plan(n, h, w, c, k=k, dilation=dilation, dtype=x.dtype,
                         align=alignment(x, out))
        _nvcc.launch(dw, x.device, DTYPES[x.dtype], x.data_ptr(),
                     kernel.data_ptr(), bias.data_ptr(), out.data_ptr(), n,
                     h, w, c, k, dilation, (2 if leaky else 1) if act else 0,
                     p.vec, p.nv, p.groups, p.tw, p.strips, p.threads,
                     p.smem)
        return out

    def fused(x, weights, *, k, dilation=1, leaky=False, interleave=True):
        n, c2, h, w = x.shape
        cb = c2 // 2
        out = _empty(x, c2 if interleave else cb, h, w)
        p = shuffle_cuda.plan(n, h, w, cb, k=k, dilation=dilation,
                              dtype=x.dtype,
                              align=alignment(x, weights.w1, weights.w3))
        _nvcc.launch(block, x.device, DTYPES[x.dtype], int(interleave),
                     x.data_ptr(), *[t.data_ptr() for t in weights.tensors()],
                     out.data_ptr(), n, h, w, cb, k, dilation,
                     2 if leaky else 1, p.th, p.tw, p.cluster, p.slice, p.vb,
                     p.smem)
        return out

    def dw_valid(x, weight):
        n, c, hin, win = x.shape
        k = weight.shape[-1]
        out = _empty(x, c, hin - k + 1, win - k + 1)
        _nvcc.launch(lab_dw, x.device, DTYPES[x.dtype], x.data_ptr(),
                     weight.data_ptr(), out.data_ptr(), n, hin - k + 1,
                     win - k + 1, c, k)
        return out

    def branch2(x2, weights):
        n, c, hin, win = x2.shape
        k = weights.wd.shape[-1]
        out = _empty(x2, c, hin - k + 1, win - k + 1)
        _nvcc.launch(lab_b2, x2.device, DTYPES[x2.dtype], x2.data_ptr(),
                     *[t.data_ptr() for t in weights.tensors()],
                     out.data_ptr(), n, hin - k + 1, win - k + 1, c, k,
                     OLD_LAB_R_TILE)
        return out

    return depthwise, fused, dw_valid, branch2


def old_cifhr(old_root):
    """The earlier CifHr kernel as a function of the new wrapper's
    arguments, its weights scaled by the caller as its wrapper did."""
    fn = _old_function(old_root, 'cifhr.cu', 'cifhr_accumulate')

    def accumulate(x, y, sigma, w, *, hr_h, hr_w, neighbors=16, factor=1.0):
        weight = (w / neighbors * factor).contiguous()
        out = torch.empty((x.shape[0], hr_h, hr_w), dtype=torch.float32,
                          device=x.device)
        _nvcc.launch(fn, x.device, x.data_ptr(), y.data_ptr(),
                     sigma.data_ptr(), weight.data_ptr(), out.data_ptr(),
                     x.shape[0], x.shape[1], hr_h, hr_w)
        return out

    return accumulate


def cases(old_root, names, device):
    """One dict per case of the kernels ``names``: name, label, old and new
    call with their kernels' names, plain version, args, kwargs and
    tolerance."""
    from torch_port_helpers import backbone_kernel_inputs, cifhr_cases, \
        lab_kernel_inputs

    rows = []

    def add(name, label, old, old_symbol, new, new_symbol, plain, args, kw,
            tol):
        if name in names:
            rows.append(dict(name=name, label=label, old=old,
                             old_symbol=old_symbol, new=new,
                             new_symbol=new_symbol, plain=plain, args=args,
                             kw=kw, tol=tol))

    def tolerance(dtype, f32_tol):
        if dtype == torch.float32:
            return f32_tol
        return lambda ref: 2.0 ** -7 * float(ref.abs().max())

    def absolute(ref):
        return 1e-5

    def relative(ref):
        return 1e-5 * float(ref.abs().max())

    if set(names) & set(BACKBONE_CASES):
        old_dw, old_fused, old_lab_dw, old_lab_b2 = old_calls(old_root)

        def old_branch2(x, weights, **kw):
            return old_fused(x, weights, interleave=False, **kw)

        for dtype in (torch.float32, torch.bfloat16):
            for cb, h, w in STAGES:
                for name, old, new, plain, c in (
                        ('depthwise_conv', old_dw, dw_cuda.depthwise_conv,
                         dw_cuda.depthwise_conv_plain, cb),
                        ('shuffle_block', old_fused, shuffle_cuda.fused_block,
                         shuffle_cuda.fused_block_plain, 2 * cb),
                        ('shuffle_branch2', old_branch2,
                         block_cuda.branch2_apply, shuffle_cuda.branch2_plain,
                         2 * cb)):
                    if name not in names:
                        continue
                    symbol = BACKBONE_SYMBOLS[name]
                    args, kw = backbone_kernel_inputs(
                        name, (1, c, h, w), dtype=dtype, device=device)
                    add(name, f'{(1, c, h, w)} {str(dtype)[6:]}', old, symbol,
                        new, symbol, plain, args, kw,
                        tolerance(dtype, absolute))
            for h, w, c in LAB_STAGES.values():
                for name, old, old_symbol, new, new_symbol, plain in (
                        ('lab_dw_valid', old_lab_dw, 'dw_valid_kernel',
                         lab_kernels.dw_valid, 'depthwise_kernel',
                         lab_kernels.dw_valid_plain),
                        ('lab_branch2', old_lab_b2, 'branch2_kernel',
                         lab_kernels.branch2, 'shuffle_block_kernel',
                         lab_kernels.branch2_plain)):
                    if name not in names:
                        continue
                    args = lab_kernel_inputs(name, h, w, c, dtype=dtype,
                                             device=device)
                    add(name, f'{(h, w, c)} {str(dtype)[6:]}', old,
                        old_symbol, new, new_symbol, plain, args, {},
                        tolerance(dtype, relative))
    if 'cifhr' in names:
        old = old_cifhr(old_root)
        kw = dict(hr_h=CIFHR_HW[0], hr_w=CIFHR_HW[1])
        for label, cells in cifhr_cases(CIFHR_SHAPES, *CIFHR_HW,
                                        device).items():
            add('cifhr', f'{label} {CIFHR_HW}', old, 'cifhr_kernel',
                cifhr_cuda.accumulate, 'cifhr_band_kernel',
                cifhr.accumulate_dense, cells, kw, lambda ref: 0.0)
    return rows


def call_ms(fn, n):
    """Milliseconds per call of ``fn`` over ``n`` back-to-back calls, from
    CUDA events after one warm-up: the wrapper's host time and its device
    ops, whichever is longer."""
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


def ab(old_root, names, device, card):
    """Each case's old and new kernel against the plain version, then
    their device times alone and their call times in turns old, new, new,
    old."""
    results = []
    for case in cases(old_root, names, device):
        args, kw = case['args'], case['kw']
        ref = case['plain'](*args, **kw).float()
        tol = case['tol'](ref)
        errs = [float((fn(*args, **kw).float() - ref).abs().max())
                for fn in (case['old'], case['new'])]
        if not max(errs) <= tol:
            raise AssertionError(f'{case["name"]} {case["label"]}: errors '
                                 f'{errs} (old, new), tol {tol}')
        times = {'old': [], 'new': []}
        calls = {'old': [], 'new': []}
        for version in ('old', 'new', 'new', 'old'):
            fn = functools.partial(case[version], *args, **kw)
            times[version].append(
                device_ms(fn, CALLS, case[f'{version}_symbol']))
            calls[version].append(call_ms(fn, CALLS))
        row = dict(kernel=case['name'], case=case['label'],
                   old_ms=times['old'], new_ms=times['new'],
                   old_call_ms=calls['old'], new_call_ms=calls['new'],
                   old_err=errs[0], new_err=errs[1])
        results.append(row)
        print(f'{case["name"]} {case["label"]}: device ms per call old '
              f'{times["old"]}, new {times["new"]}; call ms (host '
              f'included) old {calls["old"]}, new {calls["new"]}; max abs '
              f'err old {errs[0]:.3g}, new {errs[1]:.3g} (tol {tol:.3g}) '
              f'[{card}]', flush=True)
    return results


def cifhr_plans(device, card):
    """This checkout's CifHr kernel under each plan of a grid (row groups
    of warps; bands per CTA; at most 512, 256 or 128 threads) on every
    CifHr case
    and on no cells at all (the kernel's store stream alone), each
    checked bit for bit against the plain version: device ms per call.
    Plans that a grid point repeats are timed once. Beside them, ``zero_``
    of each map size: the card's write floor."""
    from torch_port_helpers import cifhr_cases

    kw = dict(hr_h=CIFHR_HW[0], hr_w=CIFHR_HW[1])
    results = []
    inputs = cifhr_cases(CIFHR_SHAPES, *CIFHR_HW, device)
    inputs['F=17 K=0'] = [torch.empty((17, 0), device=device)] * 4
    for n_fields in sorted({cells[0].shape[0] for cells in inputs.values()}):
        out = torch.empty((n_fields,) + CIFHR_HW, device=device)
        ms = device_ms(out.zero_, CALLS)
        results.append(dict(case=f'zero_ F={n_fields}', device_ms=ms))
        print(f'cifhr_plans write floor, zero_ of {tuple(out.shape)}: device '
              f'{ms} ms per call [{card}]', flush=True)
    for label, cells in inputs.items():
        ref = cifhr.accumulate_dense(*cells, **kw)
        n_fields, n_cells = cells[0].shape
        plans = dict.fromkeys(
            cifhr_cuda.plan(n_fields, n_cells, *CIFHR_HW, groups=groups,
                            bands_per_cta=bands, max_threads=threads)
            for groups in (1, 2, 4) for bands in (2, 3, 4, 6, 8)
            for threads in (512, 256, 128))
        for p in plans:
            call = functools.partial(cifhr_cuda.launch, *cells, p, **kw)
            if not torch.equal(call(), ref):
                raise AssertionError(f'cifhr {label} plan {p}: not equal to '
                                     'the plain version')
            ms = device_ms(call, CALLS, 'cifhr_band_kernel')
            results.append(dict(case=label, plan=dataclasses.asdict(p),
                                device_ms=ms))
            print(f'cifhr_plans {label}: {cifhr_cuda.describe(p)}: device '
                  f'{ms} ms per call [{card}]', flush=True)
    return results


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    names = argv[1:] or [c for c in CASES if c != 'cifhr_plans']
    if not argv or not set(names) <= set(CASES):
        sys.exit(__doc__)
    if not torch.cuda.is_available():
        raise RuntimeError('kernel_ab times CUDA kernels and needs a CUDA '
                           'device')
    sys.path.insert(0, os.path.join(os.path.dirname(_nvcc.CSRC), os.pardir,
                                    'tests'))

    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    device = torch.device('cuda:0')
    torch.backends.cudnn.allow_tf32 = False
    results = {'card': card, 'ab': ab(argv[0], names, device, card)}
    if 'cifhr_plans' in names:
        results['cifhr_plans'] = cifhr_plans(device, card)
    print(json.dumps(results))
    return results


if __name__ == '__main__':
    main()
