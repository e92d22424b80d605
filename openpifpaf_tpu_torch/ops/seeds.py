"""CifSeeds: seed extraction from CIF fields, rescored by CifHr (port of
``openpifpaf_tpu/ops/seeds.py`` on the materialised-CifHr path).

Cells with confidence >= threshold are rescored
``c' = 0.9 * cifhr(x, y) + 0.1 * c`` and taken in descending order under
a static seed budget, plus an exactness certificate: a candidate that a
budget truncated can only have lost a pose if no grown pose covers its
cell (:func:`occupancy_grid` / :func:`uncovered_any`), and the decoder
escalates to the crowd tier when that check fails.

The acceptance closures of :func:`seed_nms` and :func:`seed_rank_dedup`
are fixpoints; here each round ends in a host-side "changed?" test
(typically 2-4 rounds).
"""

import torch

from .cifhr import cifhr_lookup
from .topk import top_k


def _fixpoint(step, start):
    """Iterate ``state = step(state)`` until it stops changing."""
    state = start
    while True:
        new = step(state)
        if torch.equal(new, state):
            return new
        state = new


def _grid_shape(hr_shape, reduction):
    hs, ws = hr_shape
    return int(hs / reduction) + 1, int(ws / reduction) + 1


def _window(x, y, sigma, gh, gw):
    """``Occupancy::set`` window [x - sigma, x + sigma) clamped to the
    grid, as float (minx, maxx, miny, maxy)."""
    minx = torch.clamp(torch.floor(x - sigma), 0, gw - 1)
    maxx = torch.clamp_max(torch.maximum(torch.floor(x + sigma), minx + 1),
                           gw)
    miny = torch.clamp(torch.floor(y - sigma), 0, gh - 1)
    maxy = torch.clamp_max(torch.maximum(torch.floor(y + sigma), miny + 1),
                           gh)
    return minx, maxx, miny, maxy


def _query_cell(x, y, gh, gw):
    """Grid cell a point query reads (truncation toward zero), as float."""
    xi = torch.clamp(x.to(torch.int32), 0, gw - 1).to(torch.float32)
    yi = torch.clamp(y.to(torch.int32), 0, gh - 1).to(torch.float32)
    return xi, yi


def cif_seeds(cif, hr, stride, *, threshold=0.2, n_seeds=256, rescore=True,
              return_candidates=False):
    """Top-``n_seeds`` seeds, sorted by v descending.

    cif: (F, 5, H, W); hr: (F, HS, WS) materialised CifHr.
    Returns a dict of length-``n_seeds`` tensors f (int64), v, x, y, s
    (hi-res pixels); invalid seeds have v == 0. With ``return_candidates``
    also the dense (F * H * W,) candidate dict ``f``/``x``/``y`` with bool
    ``dropped``: every cell that could be a seed but a static budget
    truncated (the ``n_seeds`` top-k, or the ``4 * n_seeds`` compaction
    before the CifHr rescore, counted by raw threshold).
    """
    n_fields, _, h, w = cif.shape
    hw = h * w

    c = cif[:, 1].reshape(n_fields, hw)
    x = cif[:, 2].reshape(n_fields, hw) * stride
    y = cif[:, 3].reshape(n_fields, hw) * stride
    s = cif[:, 4].reshape(n_fields, hw) * stride
    mask = c >= threshold
    f_idx = torch.arange(n_fields, device=cif.device)[:, None].expand(
        n_fields, hw)
    c, x, y, s, f_idx, mask = (a.reshape(-1)
                               for a in (c, x, y, s, f_idx, mask))

    # compact the above-threshold cells to 4 * n_seeds before the CifHr
    # lookup; cells beyond the width join the dropped candidates below
    mask_full = mask
    x_full, y_full, f_full = x, y, f_idx
    m = min(4 * n_seeds, c.shape[0])
    pre_v, pre_i = top_k(torch.where(mask, c, -torch.inf), m)
    x, y, s, f_idx = (a[pre_i] for a in (x, y, s, f_idx))
    if rescore:
        hr_val = cifhr_lookup(hr, f_idx, x, y, default=-1.0)
        v = 0.9 * hr_val + 0.1 * pre_v
    else:
        v = pre_v

    mask = torch.isfinite(pre_v) & (v >= threshold)
    scored = torch.where(mask, v, -torch.inf)
    k = min(n_seeds, scored.shape[0])
    top_v, top_i = top_k(scored, k)

    valid = torch.isfinite(top_v)
    out = {
        'f': torch.where(valid, f_idx[top_i], 0),
        'v': torch.where(valid, top_v, 0.0),
        'x': torch.where(valid, x[top_i], 0.0),
        'y': torch.where(valid, y[top_i], 0.0),
        's': torch.where(valid, s[top_i], 0.0),
    }
    if not return_candidates:
        return out
    # top_i and pre_i hold distinct indices: plain scatters, no collisions
    n_full = mask_full.shape[0]
    sel_m = torch.zeros((m,), dtype=torch.bool, device=cif.device)
    sel_m[top_i] = True
    dropped = torch.zeros((n_full,), dtype=torch.bool, device=cif.device)
    dropped[pre_i] = mask & ~sel_m
    in_m = torch.zeros((n_full,), dtype=torch.bool, device=cif.device)
    in_m[pre_i] = torch.isfinite(pre_v)
    dropped = dropped | (mask_full & ~in_m)
    return out, {'f': f_full, 'x': x_full, 'y': y_full, 'dropped': dropped}


def seed_nms(seeds, n_fields, hr_shape, *, n_keep, reduction=2.0,
             min_scale=4.0):
    """Greedy per-field occupancy suppression of redundant seeds.

    Seed j is rejected iff an accepted earlier seed i of the same field
    covers j's cell with its occupancy window; the acceptance closure is
    computed by fixpoint iteration. Returns (n_keep,) indices of accepted
    seeds in descending score order, and their validity mask.
    """
    del n_fields  # fields are compared by index; kept for the JAX signature
    gh, gw = _grid_shape(hr_shape, reduction)
    n = seeds['v'].shape[0]
    dev = seeds['v'].device

    f = seeds['f']
    v = seeds['v']
    x = seeds['x'] / reduction
    y = seeds['y'] / reduction
    sigma = torch.clamp_min(seeds['s'] / reduction, min_scale / reduction)

    xi, yi = _query_cell(x, y, gh, gw)
    minx, maxx, miny, maxy = _window(x, y, sigma, gh, gw)
    rank = torch.arange(n, device=dev)
    covers = ((f[:, None] == f[None, :])
              & (xi[None, :] >= minx[:, None]) & (xi[None, :] < maxx[:, None])
              & (yi[None, :] >= miny[:, None]) & (yi[None, :] < maxy[:, None])
              & (rank[:, None] < rank[None, :]))

    valid = v > 0.0
    accepted = _fixpoint(
        lambda accept: valid & ~torch.any(accept[:, None] & covers, dim=0),
        valid)

    # accepted seeds first, in their (already score-sorted) order
    order_score = torch.where(accepted, -rank.to(torch.float32), -torch.inf)
    _, keep_idx = top_k(order_score, min(n_keep, n))
    keep_valid = accepted[keep_idx] & (seeds['v'][keep_idx] > 0.0)
    return keep_idx, keep_valid


def seed_rank_dedup(poses, seed_f, seed_x, seed_y, valid, hr_shape, *,
                    reduction=2.0, min_scale=4.0):
    """Accept or reject grown lanes like the reference's sequential seed
    gate: lane j is accepted iff no earlier-ranked accepted lane's pose
    has a visible joint ``seed_f[j]`` whose occupancy window covers seed
    j's cell. poses: (K, n_kp, 4) in seed-rank order. Returns (K,) bool.
    """
    k = poses.shape[0]
    gh, gw = _grid_shape(hr_shape, reduction)

    # blocker lane i's joint seed_f[j] for every seed lane j: (K, K, 4)
    rows = poses[:, seed_f, :]
    jv = rows[..., 0]
    jx = rows[..., 1] / reduction
    jy = rows[..., 2] / reduction
    jsig = torch.clamp_min(rows[..., 3] / reduction, min_scale / reduction)
    minx, maxx, miny, maxy = _window(jx, jy, jsig, gh, gw)
    xi, yi = _query_cell(seed_x / reduction, seed_y / reduction, gh, gw)

    rank = torch.arange(k, device=poses.device)
    covers = ((jv > 0.0)
              & (xi[None, :] >= minx) & (xi[None, :] < maxx)
              & (yi[None, :] >= miny) & (yi[None, :] < maxy)
              & (rank[:, None] < rank[None, :]))
    return _fixpoint(
        lambda accept: valid & ~torch.any(accept[:, None] & covers, dim=0),
        valid)


def occupancy_grid(poses, hr_shape, *, reduction=2.0, min_scale=4.0):
    """Occupancy grid (n_kp, gh, gw) marked by every joint (v > 0) of every
    pose with ``Occupancy::set`` window semantics, built as a summed-area
    table: +-1 at the four window corners, then a 2-D inclusive cumsum."""
    k, n_kp, _ = poses.shape
    gh, gw = _grid_shape(hr_shape, reduction)

    v = poses[:, :, 0]
    x = poses[:, :, 1] / reduction
    y = poses[:, :, 2] / reduction
    sigma = torch.clamp_min(poses[:, :, 3] / reduction, min_scale / reduction)
    minx, maxx, miny, maxy = (a.to(torch.int64)
                              for a in _window(x, y, sigma, gh, gw))

    val = (v > 0.0).to(torch.int32)
    f = torch.arange(n_kp, device=poses.device)[None, :].expand(k, n_kp)
    corners = torch.zeros((n_kp, gh + 1, gw + 1), dtype=torch.int32,
                          device=poses.device)
    # integer adds: the result does not depend on the order of collisions
    corners.index_put_((f, miny, minx), val, accumulate=True)
    corners.index_put_((f, miny, maxx), -val, accumulate=True)
    corners.index_put_((f, maxy, minx), -val, accumulate=True)
    corners.index_put_((f, maxy, maxx), val, accumulate=True)
    counts = torch.cumsum(torch.cumsum(corners, dim=1), dim=2)
    return counts[:, :gh, :gw] > 0


def uncovered_any(f, x, y, mask, occ, *, reduction=2.0):
    """True when any masked candidate's grid cell is not covered by
    ``occ`` (from :func:`occupancy_grid`)."""
    gh, gw = occ.shape[1], occ.shape[2]
    xi = torch.clamp((x / reduction).to(torch.int64), 0, gw - 1)
    yi = torch.clamp((y / reduction).to(torch.int64), 0, gh - 1)
    return torch.any(mask & ~occ[f, yi, xi])
