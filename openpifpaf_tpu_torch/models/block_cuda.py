"""Branch2 of a ShuffleNetV2K repeat block in one launch, the interleave
left to PyTorch.

Replaces the Pallas TPU kernel ``openpifpaf_tpu/models/block_pallas.py::
_branch2_kernel`` (driven by ``branch2_apply``, chained by ``run_segment``
and ``build_mosaic_forward``): branch2 (1x1 + act, KxK depthwise, 1x1 +
act) with y1 and z kept on chip. The TPU kernel folds the channel split
into zero weight rows and masks y1 on the padded border. It is the same
computation as the fused block of :mod:`.shuffle_cuda` without the
interleave, so it is that kernel's ``interleave=False`` mode: it reads x2
at a channel offset of ``Cb`` of the whole input and writes branch2's
(N, Cb, H, W) output; :func:`run_segment` interleaves in PyTorch, as the
JAX package does in XLA. The design (a cluster of CTAs per output tile,
channel slices per CTA, tensor-core products in bfloat16, the launch plan
chosen per call) and what bounds it are those of :mod:`.shuffle_cuda`.

:func:`branch2_apply` runs :func:`branch2_plain` for a tensor on the CPU;
for a CUDA tensor it launches the kernel or raises.
"""

import torch

from . import shuffle_cuda
from .basenetworks import channel_interleave2
from .fused_inference import block_forward
from .shuffle_cuda import block_weights_from_folded as \
    branch2_weights_from_folded  # noqa: F401 (the JAX package's name)
from .shuffle_cuda import branch2_plain

#: kernel launches made by :func:`branch2_apply` in this process
LAUNCHES = 0


def branch2_apply(x, weights, *, k, dilation=1, leaky=False):
    """Branch2 of a repeat block on the channels_last (N, 2Cb, H, W)
    activation; returns (N, Cb, H, W) channels_last."""
    global LAUNCHES
    if x.device.type == 'cpu':
        return branch2_plain(x, weights, k=k, dilation=dilation, leaky=leaky)
    out = shuffle_cuda.launch(x, weights, k=k, dilation=dilation,
                              leaky=leaky, interleave=False)
    LAUNCHES += 1
    return out


def run_segment(x, weights_list, *, k, dilation=1, leaky=False):
    """A chain of repeat blocks: per block, the kernel's branch2, then the
    channel interleave with the passthrough half in PyTorch."""
    cb = x.shape[1] // 2
    for weights in weights_list:
        y3 = branch2_apply(x, weights, k=k, dilation=dilation, leaky=leaky)
        x = channel_interleave2(x[:, :cb], y3)
    return x


def build_mosaic_forward(folded, *, dtype=torch.bfloat16):
    """Forward fn of the folded backbone in ``dtype`` with every non-first
    stride-1 block through the branch2 kernel and an interleave in PyTorch,
    the rest on cuDNN. Takes and returns channels_last NCHW tensors."""
    return block_forward(folded, dtype, _one_block_segment)


def _one_block_segment(x, weights, **kwargs):
    return run_segment(x, [weights], **kwargs)
