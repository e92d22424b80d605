"""BatchNorm statistics over the ranks of a data-parallel step.

JAX's sharded train step normalises with the mean and variance of the
global batch (GSPMD turns the reductions into collectives). Under DDP
each rank sees its shard only, so :func:`cross_rank_batch_norm` all-reduces
the per-channel count, sum and sum of squares, then the sum of squared
deviations from the global mean (the variance it normalises with, in two
passes as ``F.batch_norm`` computes it: E[x^2] - E[x]^2 cancels where the
mean is large), and the two per-channel sums of its backward, over a
process group. It runs under gloo on the CPU and NCCL on the card
(``torch.nn.SyncBatchNorm`` refuses CPU tensors). On the spatial mesh
:func:`rows_batch_norm` takes the statistics of an activation split along
H over the owned rows of its shards and every rank.
"""

import torch
import torch.distributed as dist


def _all_reduce(tensor, group):
    dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)
    return tensor


class _CrossRankBatchNorm(torch.autograd.Function):
    """``y = (x - mean) / sqrt(var + eps) * weight + bias`` with the mean
    and the biased variance of ``x`` (N, C, H, W) over every rank's
    batch; also returns the mean and flax's E[x^2] - E[x]^2 variance (the
    running statistics' rule). The backward is the gradient of the sum of
    every rank's loss: the input's gradient reduces its two per-channel
    sums over the ranks; weight and bias get this rank's share, which DDP
    then averages."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        c = x.shape[1]
        stats = torch.cat([
            x.new_full((1,), x.numel() // c),
            x.sum((0, 2, 3)),
            (x * x).sum((0, 2, 3)),
        ])
        stats = _all_reduce(stats, group)
        count = stats[0]
        mean = stats[1:1 + c] / count
        flax_var = (stats[1 + c:] / count - mean * mean).clamp(min=0.0)
        centered = x - mean[None, :, None, None]
        var = _all_reduce((centered * centered).sum((0, 2, 3)),
                          group) / count
        invstd = torch.rsqrt(var + eps)
        x_hat = centered * invstd[None, :, None, None]
        ctx.save_for_backward(x_hat, weight, invstd, count)
        ctx.group = group
        ctx.mark_non_differentiable(mean, flax_var)
        y = x_hat * weight[None, :, None, None] + bias[None, :, None, None]
        return y, mean, flax_var

    @staticmethod
    def backward(ctx, grad_y, _grad_mean, _grad_var):
        x_hat, weight, invstd, count = ctx.saved_tensors
        sum_dy = grad_y.sum((0, 2, 3))
        sum_dy_xhat = (grad_y * x_hat).sum((0, 2, 3))
        c = sum_dy.shape[0]
        sums = _all_reduce(torch.cat([sum_dy, sum_dy_xhat]), ctx.group)
        mean_dy = (sums[:c] / count)[None, :, None, None]
        mean_dy_xhat = (sums[c:] / count)[None, :, None, None]
        grad_x = (weight * invstd)[None, :, None, None] * (
            grad_y - mean_dy - x_hat * mean_dy_xhat)
        return grad_x, sum_dy_xhat, sum_dy, None, None


def cross_rank_batch_norm(x, weight, bias, eps, group):
    """BatchNorm of ``x`` (N, C, H, W) in train mode over the batches of
    every rank of ``group``; returns ``(y, mean, var)``, the statistics
    for the running buffers (the variance as flax's E[x^2] - E[x]^2)."""
    return _CrossRankBatchNorm.apply(x, weight, bias, eps, group)


def rows_batch_norm(norms, rows, train):
    """A :class:`..models.basenetworks.BatchNorm` on an activation split
    along H (:class:`.spatial.Rows`), ``norms[k]`` the module of local
    shard ``k``. In eval it is per pixel on each shard. In train the
    count, sum and sum of squares (and the backward's two sums) are taken
    over the owned rows of every local shard, never over halo rows, and,
    with the module's process group, reduced over every rank of the data x
    space mesh (:func:`cross_rank_batch_norm`): the local shards are
    concatenated along H for the first module, which keeps the batch
    statistics, and split back."""
    if not train:
        return rows.map(lambda k, x: norms[k](x, False))
    first = rows.parts[0].device
    y = norms[0](torch.cat([p.to(first) for p in rows.parts], dim=rows.dim),
                 True)
    parts = []
    start = 0
    for p in rows.parts:
        height = p.shape[rows.dim]
        parts.append(y.narrow(rows.dim, start, height).to(p.device))
        start += height
    return rows.like(parts)
