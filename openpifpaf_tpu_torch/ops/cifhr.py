"""CifHr: high-resolution accumulation of CIF fields (port of
``openpifpaf_tpu/ops/cifhr.py``).

Every CIF cell with confidence >= threshold splats a truncated Gaussian
(8-term ``approx_exp``) of amplitude ``v / neighbors`` centred at its
stride-upscaled regressed position, with ``sigma = max(1, 0.5 * scale *
stride)``, truncated at 1 sigma. The whole map is

    hr[f, Y, X] = min(1, sum_k w_k * g_k(X, Y))

bounded by a static top-K selection of contributing cells per field.
:func:`accumulate_dense` is the plain PyTorch version; on CUDA tensors
:func:`cif_hr` runs the hand-written kernel in :mod:`.cifhr_cuda`. The
lazy CifHr (:func:`cif_hr_cells`, :func:`eval_cells`) keeps the cells and
evaluates the map only at the points the decode reads.
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


def scaled_weights(w, neighbors, factor):
    """``w / neighbors * factor`` in float32, with a correctly rounded
    division on every device (PyTorch on CUDA divides by a Python number
    as a product with its rounded reciprocal)."""
    return w / torch.tensor(float(neighbors), device=w.device) * factor


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
    cw_all = scaled_weights(w, neighbors, factor)

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


#: values of ``cif_hr``'s ``impl`` (the decoder's ``cifhr_impl`` adds
#: ``'lazy'``, which never materialises the map: :func:`cif_hr_cells`)
MAP_IMPLS = ('auto', 'pallas', 'dense')


def cif_hr(cif, stride, *, threshold=0.3, min_scale=0.0, neighbors=16,
           factor=1.0, n_cells=256, impl='auto', return_overflow=False):
    """Full CifHr from a decoded CIF field. Returns (F, HS, WS).

    impl: ``'pallas'``, the CUDA kernel (:func:`.cifhr_cuda.accumulate`,
    the counterpart of the Pallas kernel), which raises ``ValueError`` for
    a tensor that is not on a CUDA device; ``'dense'``, the plain version
    (:func:`accumulate_dense`) on any device; ``'auto'``, the kernel for a
    CUDA tensor and the plain version for a CPU tensor. The kernel has no
    per-tile budget, so the overflow flag is the ``select_cells`` budget
    flag alone.
    """
    from . import cifhr_cuda

    if impl not in MAP_IMPLS:
        raise ValueError(f'cif_hr: impl {impl!r} is not one of {MAP_IMPLS} '
                         "(the lazy CifHr is cif_hr_cells + eval_cells)")
    if impl == 'pallas' and cif.device.type != 'cuda':
        raise ValueError(f"cif_hr(impl='pallas') needs a CUDA tensor, got "
                         f'{cif.device}')
    _, _, h, w = cif.shape
    hr_h = (h - 1) * stride + 1
    hr_w = (w - 1) * stride + 1
    x, y, sigma, wgt, overflow = select_cells(
        cif, stride, threshold=threshold, min_scale=min_scale,
        n_cells=n_cells)
    accumulate = accumulate_dense if impl == 'dense' \
        else cifhr_cuda.accumulate
    hr = accumulate(x, y, sigma, wgt, hr_h=hr_h, hr_w=hr_w,
                    neighbors=neighbors, factor=factor)
    if return_overflow:
        return hr, overflow
    return hr


def cif_hr_cells(cif, stride, *, threshold=0.3, min_scale=0.0, neighbors=16,
                 factor=1.0, n_cells=256):
    """Lazy CifHr: the splat cells instead of the map. The decode only
    point-reads CifHr (seed and CAF rescoring), so :func:`eval_cells`
    evaluates ``min(1, sum_k w_k * g_k)`` at the query points directly.
    Returns (cells dict of (F, n_cells) tensors x, y, sigma, w with w
    scaled by ``factor / neighbors``, hr_h, hr_w, overflow)."""
    _, _, h, w = cif.shape
    hr_h = (h - 1) * stride + 1
    hr_w = (w - 1) * stride + 1
    x, y, sigma, wgt, overflow = select_cells(
        cif, stride, threshold=threshold, min_scale=min_scale,
        n_cells=n_cells)
    cells = {'x': x, 'y': y, 'sigma': sigma,
             'w': scaled_weights(wgt, neighbors, factor)}
    return cells, hr_h, hr_w, overflow


def eval_cells(cells, xq, yq, *, hs, ws, default=-1.0):
    """The lazy CifHr at query points, with the rounded-pixel semantics of
    :func:`cifhr_lookup`. cells: dict of (..., K) tensors; xq, yq: (..., Q)
    hi-res coordinates whose leading axes broadcast against the cells'.
    Returns (..., Q); out-of-bounds queries give ``default``. Equals
    :func:`accumulate_dense` + :func:`cifhr_lookup` up to float summation
    order. Builds (..., Q, K) temporaries."""
    inb = (xq >= -0.49) & (yq >= -0.49) & (xq <= ws - 0.51) \
        & (yq <= hs - 0.51)
    xi = torch.clamp(torch.floor(xq + 0.5), 0, ws - 1)
    yi = torch.clamp(torch.floor(yq + 0.5), 0, hs - 1)

    dx2 = (xi[..., :, None] - cells['x'][..., None, :]) ** 2   # (..., Q, K)
    dy2 = (yi[..., :, None] - cells['y'][..., None, :]) ** 2
    d2 = dx2 + dy2
    s2 = (cells['sigma'] * cells['sigma'])[..., None, :]
    closest = (dx2 < 0.25) & (dy2 < 0.25)
    g = torch.where(closest, 1.0, approx_exp(-0.5 * d2 / s2))
    contrib = torch.where(d2 <= s2, cells['w'][..., None, :] * g, 0.0)
    val = torch.clamp_max(contrib.sum(dim=-1), 1.0)
    return torch.where(inb, val, default)


def cifhr_lookup(hr, f, x, y, default=-1.0):
    """Point lookup with the reference rounding and bounds
    (``cif_seeds.cpp:17-30``). hr: (F, HS, WS); f, x, y broadcastable; a
    field index beyond F - 1 reads field F - 1, as JAX's gather clamps."""
    hs, ws = hr.shape[-2], hr.shape[-1]
    f = torch.clamp_max(torch.as_tensor(f, device=hr.device), hr.shape[0] - 1)
    inb = (x >= -0.49) & (y >= -0.49) & (x <= ws - 0.51) & (y <= hs - 0.51)
    xi = torch.clamp(torch.floor(x + 0.5).to(torch.int64), 0, ws - 1)
    yi = torch.clamp(torch.floor(y + 0.5).to(torch.int64), 0, hs - 1)
    value = hr[f, yi, xi]
    return torch.where(inb, value, default)
