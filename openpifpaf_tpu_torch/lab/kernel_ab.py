"""A/B of the backbone kernels and of the lab's depthwise and branch2
against the sources of an earlier commit, on one card, in one process:

    python -m openpifpaf_tpu_torch.lab.kernel_ab OLD_ROOT

``OLD_ROOT`` is an unpacked earlier commit of the repo (for example
``git archive 32bd13f | tar -x -C .chipwork/old``) whose
``openpifpaf_tpu_torch/csrc`` has these C interfaces:

- ``depthwise.cu``: ``depthwise_conv(dtype, x, w, b, out, n, h, w, c, k,
  dilation, act, vec, nv, groups, tw, strips, threads, smem, stream)``,
  'SAME' only (this checkout adds ``valid`` after ``dtype``);
- ``shuffle_block.cu``: ``shuffle_block(dtype, interleave, x, w1, b1, wdw,
  bdw, w3, b3, out, n, h, w, cb, k, dilation, act, th, tw, cluster, slice,
  vb, smem, stream)`` (this checkout's modes 1 and 0);
- ``mosaic_lab.cu``: the lab's own kernels ``lab_dw_valid(dtype, x, w, out,
  n, h, w, c, k, stream)`` and ``lab_branch2(dtype, x2, w1, b1, wd, bd, w3,
  b3, out, n, h, w, c, k, r_tile, stream)``, run at 4 tile rows.

Both versions are built with this checkout's nvcc flags, and the backbone
kernels of both run with this checkout's launch plans (``dw_cuda.plan``,
``shuffle_cuda.plan``).

Cases: the depthwise conv and both modes of the fused block at k16's three
stage shapes for a 513x641 input; the lab's VALID depthwise conv and
branch2 at the lab's three stages (``mosaic_lab.STAGES``), against this
checkout's VALID and lab modes of the same kernels. Each in float32 and
bfloat16 (TF32 off): both versions are checked against the plain version
(float32 1e-5, absolute for the backbone kernels and of the largest output
for the lab's; bfloat16 one rounding step of the largest output), then
each version's device time alone per call is taken from ``torch.profiler``
(20 back-to-back calls) in turns: old, new, new, old. It prints one line
per case, the card's ``nvidia-smi`` name and power limit, and a JSON line
of the results. It needs a CUDA device.
"""

import ctypes
import json
import os
import subprocess
import sys

import torch

from .. import _nvcc
from ..models import block_cuda, dw_cuda, shuffle_cuda
from ..models.dw_cuda import DTYPES, alignment
from . import kernels as lab_kernels
from .mosaic_lab import STAGES as LAB_STAGES
from .timing import device_ms

#: (Cb, H, W) of shufflenetv2k16's stages 2-4 for a 513x641 input
STAGES = ((174, 129, 161), (348, 65, 81), (696, 33, 41))
CALLS = 20
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


def cases(old_root):
    """(name, old call, its kernel's name, new call, its kernel's name,
    plain, inputs(dtype, device) -> (args, kwargs), float32 tolerance(ref))
    for each case."""
    from torch_port_helpers import backbone_kernel_inputs, lab_kernel_inputs

    old_dw, old_fused, old_lab_dw, old_lab_b2 = old_calls(old_root)

    def old_branch2(x, weights, **kw):
        return old_fused(x, weights, interleave=False, **kw)

    def backbone(name, shape):
        return lambda dtype, device: backbone_kernel_inputs(
            name, shape, dtype=dtype, device=device)

    def lab(name, h, w, c):
        return lambda dtype, device: (lab_kernel_inputs(
            name, h, w, c, dtype=dtype, device=device), {})

    def absolute(ref):
        return 1e-5

    def relative(ref):
        return 1e-5 * float(ref.abs().max())

    for cb, h, w in STAGES:
        yield ('depthwise_conv', old_dw, 'depthwise_kernel',
               dw_cuda.depthwise_conv, 'depthwise_kernel',
               dw_cuda.depthwise_conv_plain,
               backbone('depthwise_conv', (1, cb, h, w)), absolute)
        yield ('shuffle_block', old_fused, 'shuffle_block_kernel',
               shuffle_cuda.fused_block, 'shuffle_block_kernel',
               shuffle_cuda.fused_block_plain,
               backbone('shuffle_block', (1, 2 * cb, h, w)), absolute)
        yield ('shuffle_branch2', old_branch2, 'shuffle_block_kernel',
               block_cuda.branch2_apply, 'shuffle_block_kernel',
               shuffle_cuda.branch2_plain,
               backbone('shuffle_branch2', (1, 2 * cb, h, w)), absolute)
    for h, w, c in LAB_STAGES.values():
        yield ('lab_dw_valid', old_lab_dw, 'dw_valid_kernel',
               lab_kernels.dw_valid, 'depthwise_kernel',
               lab_kernels.dw_valid_plain, lab('lab_dw_valid', h, w, c),
               relative)
        yield ('lab_branch2', old_lab_b2, 'branch2_kernel',
               lab_kernels.branch2, 'shuffle_block_kernel',
               lab_kernels.branch2_plain, lab('lab_branch2', h, w, c),
               relative)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
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
    results = []
    for name, old, old_symbol, new, new_symbol, plain, inputs, f32_tol \
            in cases(argv[0]):
        for dtype in (torch.float32, torch.bfloat16):
            args, kw = inputs(dtype, device)
            shape = tuple(args[0].shape)
            ref = plain(*args, **kw).float()
            tol = f32_tol(ref) if dtype == torch.float32 else \
                2.0 ** -7 * float(ref.abs().max())
            errs = [float((fn(*args, **kw).float() - ref).abs().max())
                    for fn in (old, new)]
            if not max(errs) <= tol:
                raise AssertionError(f'{name} {shape} {dtype}: errors '
                                     f'{errs} (old, new), tol {tol}')
            times = {'old': [], 'new': []}
            for version in ('old', 'new', 'new', 'old'):
                fn, symbol = (old, old_symbol) if version == 'old' else \
                    (new, new_symbol)
                times[version].append(device_ms(
                    lambda: fn(*args, **kw), CALLS, symbol))
            row = dict(kernel=name, shape=shape, dtype=str(dtype)[6:],
                       old_ms=times['old'], new_ms=times['new'],
                       old_err=errs[0], new_err=errs[1])
            results.append(row)
            print(f'{name} {shape} {row["dtype"]}: device ms per call old '
                  f'{times["old"]}, new {times["new"]}; max abs err old '
                  f'{errs[0]:.3g}, new {errs[1]:.3g} (tol {tol:.3g}) '
                  f'[{card}]', flush=True)
    print(json.dumps({'card': card, 'ab': results}))
    return results


if __name__ == '__main__':
    main()
