"""A/B of the backbone kernels against an earlier version of their sources,
on one card, in one process:

    python -m openpifpaf_tpu_torch.lab.kernel_ab OLD_ROOT

``OLD_ROOT`` is an unpacked earlier commit of the repo (for example
``git archive fb47b67 | tar -x -C .chipwork/old``) whose
``openpifpaf_tpu_torch/csrc/depthwise.cu`` and ``shuffle_block.cu`` have
the first C interface: ``depthwise_conv(dtype, x, w, b, out, n, h, w, c,
k, dilation, act, stream)`` and ``shuffle_block(dtype, interleave, x, w1,
b1, wdw, bdw, w3, b3, out, n, h, w, cb, k, dilation, act, stream)``, with
no launch plan. Both are built with this checkout's nvcc flags.

For the depthwise conv and both modes of the fused block, at k16's three
stage shapes for a 513x641 input, in float32 and bfloat16 (TF32 off), it
checks that both versions agree with the plain version (float32 1e-5
absolute, bfloat16 one rounding step of the largest output), then takes
each version's device time alone per call from ``torch.profiler`` (20
back-to-back calls) in turns: old, new, new, old. It prints one line per
case, the card's ``nvidia-smi`` name and power limit, and a JSON line of
the results. It needs a CUDA device.
"""

import ctypes
import json
import os
import subprocess
import sys

import torch

from .. import _nvcc
from ..models import block_cuda, dw_cuda, shuffle_cuda
from .timing import device_ms

#: (Cb, H, W) of shufflenetv2k16's stages 2-4 for a 513x641 input
STAGES = ((174, 129, 161), (348, 65, 81), (696, 33, 41))
CALLS = 20
_OLD_DW_ARGS = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                + [ctypes.c_void_p])
_OLD_BLOCK_ARGS = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def _old_function(old_root, source, symbol, argtypes):
    lib = ctypes.CDLL(_nvcc.build(
        source, os.path.join(old_root, 'openpifpaf_tpu_torch', 'csrc')))
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def old_calls(old_root):
    """The earlier kernels as functions of the new wrappers' arguments."""
    dw = _old_function(old_root, 'depthwise.cu', 'depthwise_conv',
                       _OLD_DW_ARGS)
    block = _old_function(old_root, 'shuffle_block.cu', 'shuffle_block',
                          _OLD_BLOCK_ARGS)

    def depthwise(x, kernel, bias, *, dilation=1, act=True, leaky=False):
        out = torch.empty_like(x, memory_format=torch.channels_last)
        n, c, h, w = x.shape
        _nvcc.launch(dw, x.device, dw_cuda.DTYPES[x.dtype], x.data_ptr(),
                     kernel.data_ptr(), bias.data_ptr(), out.data_ptr(), n,
                     h, w, c, kernel.shape[-1], dilation,
                     (2 if leaky else 1) if act else 0)
        return out

    def fused(x, weights, *, k, dilation=1, leaky=False, interleave=True):
        n, c2, h, w = x.shape
        out = torch.empty((n, c2 if interleave else c2 // 2, h, w),
                          dtype=x.dtype, device=x.device,
                          memory_format=torch.channels_last)
        _nvcc.launch(block, x.device, dw_cuda.DTYPES[x.dtype],
                     int(interleave), x.data_ptr(),
                     *[t.data_ptr() for t in weights.tensors()],
                     out.data_ptr(), n, h, w, c2 // 2, k, dilation,
                     2 if leaky else 1)
        return out

    return depthwise, fused


def cases(old_root):
    """(name, kernel symbol, old call, new call, plain, input shape)."""
    old_dw, old_fused = old_calls(old_root)

    def old_branch2(x, weights, **kw):
        return old_fused(x, weights, interleave=False, **kw)

    for cb, h, w in STAGES:
        yield ('depthwise_conv', 'depthwise_kernel', old_dw,
               dw_cuda.depthwise_conv, dw_cuda.depthwise_conv_plain,
               (1, cb, h, w))
        yield ('shuffle_block', 'shuffle_block_kernel', old_fused,
               shuffle_cuda.fused_block, shuffle_cuda.fused_block_plain,
               (1, 2 * cb, h, w))
        yield ('shuffle_branch2', 'shuffle_block_kernel', old_branch2,
               block_cuda.branch2_apply, shuffle_cuda.branch2_plain,
               (1, 2 * cb, h, w))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        sys.exit(__doc__)
    if not torch.cuda.is_available():
        raise RuntimeError('kernel_ab times CUDA kernels and needs a CUDA '
                           'device')
    sys.path.insert(0, os.path.join(os.path.dirname(_nvcc.CSRC), os.pardir,
                                    'tests'))
    from torch_port_helpers import backbone_kernel_inputs

    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    device = torch.device('cuda:0')
    torch.backends.cudnn.allow_tf32 = False
    results = []
    for name, symbol, old, new, plain, shape in cases(argv[0]):
        for dtype in (torch.float32, torch.bfloat16):
            args, kw = backbone_kernel_inputs(name, shape, dtype=dtype,
                                              device=device)
            ref = plain(*args, **kw).float()
            tol = 1e-5 if dtype == torch.float32 else \
                2.0 ** -7 * float(ref.abs().max())
            errs = [float((fn(*args, **kw).float() - ref).abs().max())
                    for fn in (old, new)]
            if not max(errs) <= tol:
                raise AssertionError(f'{name} {shape} {dtype}: errors '
                                     f'{errs} (old, new), tol {tol}')
            times = {'old': [], 'new': []}
            for version in ('old', 'new', 'new', 'old'):
                fn = old if version == 'old' else new
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
