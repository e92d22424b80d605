"""CifHr: high-resolution accumulation of CIF fields (port of
``openpifpaf_tpu/ops/cifhr.py``).

Every CIF cell with confidence >= threshold splats a truncated Gaussian
(8-term ``approx_exp``) of amplitude ``v / neighbors`` centred at its
stride-upscaled regressed position, with ``sigma = max(1, 0.5 * scale *
stride)``, truncated at 1 sigma. The whole map is

    hr[f, Y, X] = min(1, sum_k w_k * g_k(X, Y))

bounded by a static top-K selection of contributing cells per field.
:func:`accumulate_dense` is the plain PyTorch version; on CUDA tensors
:func:`cif_hr` runs the hand-written kernel in :mod:`.cifhr_cuda`.
"""

import torch

from .topk import top_k


def approx_exp(x):
    """8-term exp approximation (``cif_hr.cpp:18-25`` of the reference)."""
    y = 1.0 + x / 8.0
    y = y * y
    y = y * y
    y = y * y
    return torch.where((x > 2.0) | (x < -2.0), 0.0, y)


def select_cells(cif, stride, *, threshold, min_scale, n_cells):
    """Top-``n_cells`` contributing cells per field.

    cif: (F, 5, H, W) decoded CIF field [logb, conf, x, y, scale].
    Returns (x, y, sigma, w, overflow): each (F, n_cells), positions in
    hi-res pixels, invalid cells have w == 0; overflow is a bool scalar
    tensor, True when a field had more valid cells than the budget kept.
    """
    n_fields, _, h, w = cif.shape
    v = cif[:, 1].reshape(n_fields, h * w)
    scale = cif[:, 4].reshape(n_fields, h * w)
    valid = (v >= threshold) & (scale >= min_scale / stride)

    scored = torch.where(valid, v, -torch.inf)
    k = min(n_cells, h * w)
    top_v, top_i = top_k(scored, k)
    overflow = torch.any(valid.sum(dim=1) > k)

    payload = cif[:, 2:5].reshape(n_fields, 3, h * w)
    out = torch.gather(payload, 2, top_i[:, None, :].expand(n_fields, 3, k))
    x = out[:, 0] * stride
    y = out[:, 1] * stride
    sigma = torch.clamp_min(0.5 * out[:, 2] * stride, 1.0)
    weight = torch.where(torch.isfinite(top_v), top_v, 0.0)
    return x, y, sigma, weight, overflow


def accumulate_dense(x, y, sigma, w, *, hr_h, hr_w, neighbors=16,
                     factor=1.0):
    """Plain version: loop over cells in ascending order, full-map update.

    Cells whose weight is zero in every field add exactly 0.0 and are
    skipped; every other cell runs the same float operations, in the
    same order, as ``openpifpaf_tpu.ops.cifhr.accumulate_dense``.
    """
    n_fields = x.shape[0]
    kw = dict(dtype=torch.float32, device=x.device)
    xs = torch.arange(hr_w, **kw)[None, None, :]
    ys = torch.arange(hr_h, **kw)[None, :, None]
    cw_all = w / neighbors * factor

    acc = torch.zeros((n_fields, hr_h, hr_w), **kw)
    live = torch.nonzero(torch.any(cw_all != 0.0, dim=0)).flatten().tolist()
    for k in live:
        cx = x[:, k, None, None]
        cy = y[:, k, None, None]
        cs = sigma[:, k, None, None]
        cw = cw_all[:, k, None, None]

        dx2 = (xs - cx) ** 2
        dy2 = (ys - cy) ** 2
        d2 = dx2 + dy2
        s2 = cs * cs
        inside = d2 <= s2
        closest = (dx2 < 0.25) & (dy2 < 0.25)
        g = torch.where(closest, 1.0, approx_exp(-0.5 * d2 / s2))
        acc += torch.where(inside, cw * g, 0.0)
    return torch.clamp_max(acc, 1.0)


def cif_hr(cif, stride, *, threshold=0.3, min_scale=0.0, neighbors=16,
           factor=1.0, n_cells=256, return_overflow=False):
    """Full CifHr from a decoded CIF field. Returns (F, HS, WS).

    The map comes from :func:`.cifhr_cuda.accumulate`: the CUDA kernel
    for a CUDA tensor, :func:`accumulate_dense` for a CPU tensor. The
    kernel has no per-tile budget, so the overflow flag is the
    ``select_cells`` budget flag alone.
    """
    from .cifhr_cuda import accumulate

    _, _, h, w = cif.shape
    hr_h = (h - 1) * stride + 1
    hr_w = (w - 1) * stride + 1
    x, y, sigma, wgt, overflow = select_cells(
        cif, stride, threshold=threshold, min_scale=min_scale,
        n_cells=n_cells)
    hr = accumulate(x, y, sigma, wgt, hr_h=hr_h, hr_w=hr_w,
                    neighbors=neighbors, factor=factor)
    if return_overflow:
        return hr, overflow
    return hr


def cifhr_lookup(hr, f, x, y, default=-1.0):
    """Point lookup with the reference rounding and bounds
    (``cif_seeds.cpp:17-30``). hr: (F, HS, WS); f, x, y broadcastable."""
    hs, ws = hr.shape[-2], hr.shape[-1]
    inb = (x >= -0.49) & (y >= -0.49) & (x <= ws - 0.51) & (y <= hs - 0.51)
    xi = torch.clamp(torch.floor(x + 0.5).to(torch.int64), 0, ws - 1)
    yi = torch.clamp(torch.floor(y + 0.5).to(torch.int64), 0, hs - 1)
    value = hr[f, yi, xi]
    return torch.where(inb, value, default)
