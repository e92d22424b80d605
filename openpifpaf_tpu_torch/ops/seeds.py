"""CifSeeds: seed extraction from CIF fields, rescored by CifHr (port of
``openpifpaf_tpu/ops/seeds.py``).

Cells with confidence >= threshold are rescored
``c' = 0.9 * cifhr(x, y) + 0.1 * c`` and taken in descending order under
a static seed budget, plus an exactness certificate: a candidate that a
budget truncated can only have lost a pose if no grown pose covers its
cell (:func:`occupancy_grid` / :func:`uncovered_any`), and the decoder
escalates to the crowd tier when that check fails.

The acceptance closures of :func:`seed_nms` and :func:`seed_rank_dedup`
are fixpoints, run as a while loop as JAX runs them as
``lax.while_loop``: ``torch.export`` records each as one op of the graph,
with no data-dependent guard. Each round's body copies its "changed?"
flag to the host, where the loop's test reads it, run eagerly (by the
decode) or from a loaded program: one host read per round (typically 1-6
rounds).
"""

import torch
import torch.nn.functional as F
try:  # torch's private module of the operator; torch 2.11 to 2.13 have it
    from torch._higher_order_ops.while_loop import while_loop_op
except ImportError as error:
    raise ImportError(
        'openpifpaf_tpu_torch needs the while-loop operator of '
        'torch.while_loop (torch._higher_order_ops.while_loop.'
        f'while_loop_op, in torch 2.11 to 2.13); torch {torch.__version__} '
        'does not have it there') from error

from .cifhr import cifhr_lookup, eval_cells
from .topk import top_k


def _fixpoint(step, start, *operands):
    """Iterate ``state = step(state, *operands)`` until it stops changing:
    the while-loop operator of ``torch.while_loop`` over ``(state,
    changed)``, JAX's ``lax.while_loop(lambda st: st[1], body, (start,
    True))``. ``step`` reads no tensor but ``state`` and ``operands`` and
    returns a new tensor of ``start``'s shape, dtype and device. The
    operator is called directly, with its operands explicit:
    ``torch.while_loop`` finds a closure's tensors by running each eager
    call through ``torch.compile``, which doubled the decode's host time
    on the H100."""
    def changed(state, flag, *operands):
        return flag.clone()  # the loop's functions may not return an input

    def body(state, flag, *operands):
        new = step(state, *operands)
        # the flag lives on the host: the loop reads it twice per test,
        # and a flag on the card would wait for the card each time
        return new, (new != state).any().cpu()

    flag = torch.ones((), dtype=torch.bool)
    # the carried state may alias no operand (the callers pass their
    # start as an operand too): AOTInductor's functionalisation refuses
    # a loop whose carried input is also one of its operands
    return while_loop_op(changed, body, (start.clone(), flag), operands)[0]


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


def _max_pool3(planes):
    """3x3 max of each (F, H, W) plane at every cell, the window clipped
    at the borders (``reduce_window`` with a -inf init and 'SAME')."""
    return F.max_pool2d(planes, kernel_size=3, stride=1, padding=1)


def local_peaks(conf, *, break_ties):
    """(F, H, W) bool: cells whose confidence is a 3x3 local maximum
    (``cif_seeds.cpp:36-51``). With ``break_ties``, of the peaks within one
    3x3 window only the one of largest linear index stays, which keeps one
    cell per confidence plateau (two peaks in one window have equal
    confidence). The indices pool as float64, exact below 2^53."""
    peak = conf >= _max_pool3(conf)
    if break_ties:
        n_fields, h, w = conf.shape
        idx = torch.arange(h * w, dtype=torch.float64,
                           device=conf.device).reshape(1, h, w)
        idx = idx.expand(n_fields, h, w)
        pooled = _max_pool3(torch.where(peak, idx, -1.0))
        peak = peak & (idx >= pooled)
    return peak


def cif_seeds(cif, hr, stride, *, threshold=0.2, n_seeds=256, rescore=True,
              nms=False, blob_compact=False, hr_cells=None, hr_shape=None,
              return_candidates=False):
    """Top-``n_seeds`` seeds, sorted by v descending.

    cif: (F, 5, H, W); hr: (F, HS, WS) materialised CifHr, or None with
    ``hr_cells`` (:func:`.cifhr.cif_hr_cells`) and ``hr_shape`` set, which
    evaluates the lazy CifHr at the seeds instead. ``rescore=False``
    ranks by the raw confidence (``--ablation-cifseeds-no-rescore``);
    ``nms`` keeps only cells that are 3x3 local maxima of their confidence
    plane (``--ablation-cifseeds-nms``); ``blob_compact`` does the same
    with plateau ties broken, as a compaction of the seed budget that is
    exact only for encoder-consistent fields. Returns a dict of length-``n_seeds`` tensors f (int64), v, x,
    y, s (hi-res pixels); invalid seeds have v == 0. With
    ``return_candidates`` also the dense (F * H * W,) candidate dict
    ``f``/``x``/``y`` with bool ``dropped``: every cell that could be a
    seed but a static budget truncated (the ``n_seeds`` top-k, or the
    ``4 * n_seeds`` compaction before the CifHr rescore, counted by raw
    threshold).
    """
    n_fields, _, h, w = cif.shape
    hw = h * w

    c = cif[:, 1].reshape(n_fields, hw)
    x = cif[:, 2].reshape(n_fields, hw) * stride
    y = cif[:, 3].reshape(n_fields, hw) * stride
    s = cif[:, 4].reshape(n_fields, hw) * stride
    mask = c >= threshold
    if nms or blob_compact:
        peak = local_peaks(cif[:, 1], break_ties=blob_compact and not nms)
        mask = mask & peak.reshape(n_fields, hw)
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
        if hr_cells is not None:
            rows = {k: a[f_idx] for k, a in hr_cells.items()}   # (M, K)
            hr_val = eval_cells(rows, x[:, None], y[:, None],
                                hs=hr_shape[0], ws=hr_shape[1],
                                default=-1.0)[:, 0]
        else:
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
             min_scale=4.0, occ0=None):
    """Greedy per-field occupancy suppression of redundant seeds.

    Seed j is rejected iff an accepted earlier seed i of the same field
    covers j's cell with its occupancy window; the acceptance closure is
    computed by fixpoint iteration. ``occ0`` (F, gh, gw) bool, the
    occupancy of initial poses, rejects the seeds whose cell it covers.
    Returns (n_keep,) indices of accepted seeds in descending score
    order, and their validity mask.
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
    if occ0 is not None:
        valid = valid & ~occ0[f, yi.to(torch.int64), xi.to(torch.int64)]
    accepted = _fixpoint(
        lambda accept, valid, covers:
        valid & ~torch.any(accept[:, None] & covers, dim=0),
        valid, valid, covers)

    # accepted seeds first, in their (already score-sorted) order
    order_score = torch.where(accepted, -rank.to(torch.float32), -torch.inf)
    _, keep_idx = top_k(order_score, min(n_keep, n))
    keep_valid = accepted[keep_idx] & (seeds['v'][keep_idx] > 0.0)
    return keep_idx, keep_valid


def seed_rank_dedup(poses, seed_f, seed_x, seed_y, valid, hr_shape, *,
                    n_initial=0, reduction=2.0, min_scale=4.0):
    """Accept or reject grown lanes like the reference's sequential seed
    gate: seed lane j is accepted iff no earlier-ranked accepted lane's
    pose has a visible joint ``seed_f[j]`` whose occupancy window covers
    seed j's cell. poses: (K, n_kp, 4), the ``n_initial`` lanes of initial
    poses first (always accepted: they grow before any seed), then the
    seed lanes in seed-rank order; seed_f/x/y and valid: (K - n_initial,).
    Returns (K,) bool.
    """
    k = poses.shape[0]
    gh, gw = _grid_shape(hr_shape, reduction)

    # blocker lane i's joint seed_f[j] for every seed lane j: (K, Ks, 4)
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
              & (rank[:, None] < rank[None, n_initial:]))       # (K, Ks)
    always = torch.ones((n_initial,), dtype=torch.bool, device=poses.device)
    return _fixpoint(
        lambda accept, always, valid, covers: torch.cat([always, valid & ~(
            torch.any(accept[:, None] & covers, dim=0))]),
        torch.cat([always, valid]), always, valid, covers)


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
