"""CifDet decode (port of ``openpifpaf_tpu/ops/decode_cifdet.py``).

The CifDetHr kept lazy (the top cells of each category, point-read at the
seeds), seed extraction with the 0.9/0.1 rescore, the greedy
occupancy-filtered acceptance of seeds, then IoU NMS (per category by
default) with score suppression. Batched over images, on the fields'
device.

JAX runs the occupancy and the NMS as two ``lax.scan`` loops of
``n_seeds`` steps. Both are greedy scans in which the decision on seed i
depends only on the decisions on seeds before it: seed i is kept unless a
kept earlier seed blocks it (its occupancy window holds seed i's cell in
the same category; its box overlaps seed i's above the IoU threshold).
The port writes each blocking relation as an (n, n) matrix once and runs
the scan as a bounded fixpoint (:func:`greedy_keep`): every round
recomputes all decisions from the previous round's, so after r rounds the
first r decisions are the scan's, and a round that changes nothing has
reached the scan's result. It checks for that every
:data:`FIXPOINT_ROUNDS` rounds, so a decode syncs with the host a few
times instead of once per seed, and never runs more than ``n + 1``
rounds. No kernel of its own runs here, in JAX as in the port.
"""

import dataclasses
import functools

import torch

from .cifhr import eval_cells
from .topk import top_k

#: rounds of :func:`greedy_keep` between two convergence checks (each a
#: host sync)
FIXPOINT_ROUNDS = 4


@dataclasses.dataclass(frozen=True)
class CifDetDecoderConfig:
    cifhr_threshold: float = 0.3
    cifhr_neighbors: int = 16
    cifhr_min_scale: float = 0.0
    seed_threshold: float = 0.2
    iou_threshold: float = 0.5
    nms_by_category: bool = True
    suppression: float = 0.1
    instance_threshold: float = 0.15
    occupancy_reduction: float = 2.0
    occupancy_min_scale: float = 4.0
    n_hr_cells: int = 256
    n_seeds: int = 256
    n_detections: int = 120


def select_det_cells(cifdet, stride, *, threshold, min_scale, n_cells):
    """Top cells for the lazy CifDetHr. cifdet: (B, F, 6, H, W) [logb, c,
    x, y, w, h]. Returns x, y, sigma, weight, each (B, F, K): the top
    ``n_cells`` confident cells of each category, in JAX's order (ties
    lower index first); a cell below the thresholds has weight 0."""
    batch, n_fields, _, h, w = cifdet.shape
    flat = cifdet.reshape(batch, n_fields, 6, h * w)
    v, ww, hh = flat[:, :, 1], flat[:, :, 4], flat[:, :, 5]
    valid = (v >= threshold) & (ww >= min_scale / stride) \
        & (hh >= min_scale / stride)
    scored = torch.where(valid, v, -torch.inf)
    top_v, top_i = top_k(scored, min(n_cells, h * w))
    payload = torch.gather(
        flat[:, :, 2:6], 3,
        top_i[:, :, None, :].expand(-1, -1, 4, -1))
    x = payload[:, :, 0] * stride
    y = payload[:, :, 1] * stride
    sigma = torch.clamp_min(
        0.1 * torch.minimum(payload[:, :, 2], payload[:, :, 3]) * stride,
        1.0)
    weight = torch.where(torch.isfinite(top_v), top_v, 0.0)
    return x, y, sigma, weight


def box_iou(boxes_a, boxes_b):
    """IoU between two sets of xyxy boxes: (..., A, 4) x (..., B, 4) ->
    (..., A, B)."""
    ax0, ay0, ax1, ay1 = (boxes_a[..., :, None, i] for i in range(4))
    bx0, by0, bx1, by1 = (boxes_b[..., None, :, i] for i in range(4))
    inter_w = torch.clamp_min(
        torch.minimum(ax1, bx1) - torch.maximum(ax0, bx0), 0.0)
    inter_h = torch.clamp_min(
        torch.minimum(ay1, by1) - torch.maximum(ay0, by0), 0.0)
    inter = inter_w * inter_h
    area_a = torch.clamp_min(ax1 - ax0, 0.0) * torch.clamp_min(ay1 - ay0, 0.0)
    area_b = torch.clamp_min(bx1 - bx0, 0.0) * torch.clamp_min(by1 - by0, 0.0)
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union, 0.0)


def greedy_keep(candidate, blocks, cap=None):
    """The result of the greedy scan ``for i: keep[i] = candidate[i] and
    no kept j < i blocks i [and fewer than cap kept before i]``.

    candidate: (B, n) bool; blocks: (B, n, n) bool, ``blocks[b, i, j]``
    true when seed j, kept, blocks seed i (only j < i may be set). Runs as
    a fixpoint over all seeds at once, checked every FIXPOINT_ROUNDS
    rounds, at most n + 1 rounds."""
    n = candidate.shape[-1]
    keep = candidate
    for _ in range(0, n + 1, FIXPOINT_ROUNDS):
        for _ in range(FIXPOINT_ROUNDS):
            previous = keep
            keep = candidate & ~(blocks & previous[:, None, :]).any(dim=-1)
            if cap is not None:
                before = torch.cumsum(previous, dim=-1) - previous.long()
                keep = keep & (before < cap)
        if torch.equal(keep, previous):
            break
    return keep


def _gather(values, index):
    return torch.gather(values, 1, index)


def decode_cifdet(cifdet, *, stride, config):
    """Detections of a batch of CifDet fields (B, F, 6, H, W), float32 on
    any device: a dict of (B, n_seeds) tensors ``category`` (1-based),
    ``score``, ``box`` (B, n_seeds, 4) xyxy in image pixels, and ``keep``,
    in seed order."""
    cfg = config
    batch, n_fields, _, h, w = cifdet.shape
    hw = h * w
    hr_shape = ((h - 1) * stride + 1, (w - 1) * stride + 1)
    device = cifdet.device

    # CifDetHr, kept lazy (splat cells, see cifhr.eval_cells): the
    # 80-category map would be 131 MB at 641px and is only point-read
    x, y, sigma, weight = select_det_cells(
        cifdet, stride, threshold=cfg.cifhr_threshold,
        min_scale=cfg.cifhr_min_scale, n_cells=cfg.n_hr_cells)
    hr_cells = {'x': x, 'y': y, 'sigma': sigma,
                'w': weight / cfg.cifhr_neighbors}

    # seeds (cif_seeds.cpp:69-90): v = 0.9 * hr + 0.1 * c over the top
    # 4 * n_seeds above-threshold cells
    flat = cifdet.reshape(batch, n_fields, 6, hw).transpose(1, 2).reshape(
        batch, 6, n_fields * hw)
    c = flat[:, 1]
    sx, sy, sw, sh = (flat[:, i] * stride for i in range(2, 6))
    f_idx = torch.arange(n_fields, device=device).repeat_interleave(
        hw).expand(batch, -1)
    m = min(4 * cfg.n_seeds, n_fields * hw)
    pre_v, pre_i = top_k(torch.where(c >= cfg.seed_threshold, c, -torch.inf),
                         m)
    sx, sy, sw, sh, f_idx = (_gather(a, pre_i)
                             for a in (sx, sy, sw, sh, f_idx))
    rows = {k: torch.gather(a, 1, f_idx[:, :, None].expand(
        -1, -1, a.shape[-1])) for k, a in hr_cells.items()}
    hr_val = eval_cells(rows, sx[:, :, None], sy[:, :, None],
                        hs=hr_shape[0], ws=hr_shape[1], default=-1.0)[:, :, 0]
    v = 0.9 * hr_val + 0.1 * pre_v
    mask = torch.isfinite(pre_v) & (v >= cfg.seed_threshold)
    top_v, top_i = top_k(torch.where(mask, v, -torch.inf),
                         min(cfg.n_seeds, m))
    valid = torch.isfinite(top_v)
    seed_f = torch.where(valid, _gather(f_idx, top_i), 0)
    seed_v = torch.where(valid, top_v, 0.0)
    seed_x, seed_y, seed_w, seed_h = (_gather(a, top_i)
                                      for a in (sx, sy, sw, sh))

    # greedy occupancy (cifdet.cpp:50-65): a seed is accepted unless its
    # cell lies in the window of an accepted seed of its category, up to
    # n_detections; JAX's occupancy grid of int(hr / red) + 1 cells per
    # axis gives the clip bounds
    red = cfg.occupancy_reduction
    gh = int(hr_shape[0] / red) + 1
    gw = int(hr_shape[1] / red) + 1
    xg = seed_x / red
    yg = seed_y / red
    sig = torch.clamp_min(0.1 * torch.minimum(seed_w, seed_h) / red,
                          cfg.occupancy_min_scale / red)
    # int32 casts truncate toward zero; XLA's saturates (NaN to 0), so the
    # value is bounded before the cast, which keeps the clipped result
    xi = torch.nan_to_num(xg, nan=0.0).clamp(-1.0, float(gw)).to(
        torch.int64).clamp(0, gw - 1).float()
    yi = torch.nan_to_num(yg, nan=0.0).clamp(-1.0, float(gh)).to(
        torch.int64).clamp(0, gh - 1).float()
    minx = torch.clamp(torch.floor(xg - sig), 0, gw - 1)
    maxx = torch.clamp_max(torch.maximum(torch.floor(xg + sig), minx + 1), gw)
    miny = torch.clamp(torch.floor(yg - sig), 0, gh - 1)
    maxy = torch.clamp_max(torch.maximum(torch.floor(yg + sig), miny + 1), gh)
    n = seed_v.shape[-1]
    earlier = torch.ones(n, n, dtype=torch.bool, device=device).tril(-1)
    in_window = ((xi[:, :, None] >= minx[:, None, :])
                 & (xi[:, :, None] < maxx[:, None, :])
                 & (yi[:, :, None] >= miny[:, None, :])
                 & (yi[:, :, None] < maxy[:, None, :]))
    same_f = seed_f[:, :, None] == seed_f[:, None, :]
    accepted = greedy_keep(seed_v > 0.0, earlier & same_f & in_window,
                           cap=cfg.n_detections)

    det_scores = torch.where(accepted, seed_v, 0.0)
    boxes = torch.stack([
        seed_x - 0.5 * seed_w, seed_y - 0.5 * seed_h,
        seed_x + 0.5 * seed_w, seed_y + 0.5 * seed_h], dim=-1)

    # IoU NMS with suppression (decoder/cifdet.py:60-72), in descending
    # score order, ties in seed order (JAX's stable argsort)
    s_sorted, order = torch.sort(det_scores, dim=-1, descending=True,
                                 stable=True)
    b_sorted = torch.gather(boxes, 1, order[:, :, None].expand(-1, -1, 4))
    f_sorted = _gather(seed_f, order)
    iou = box_iou(b_sorted, b_sorted)
    if cfg.nms_by_category:
        iou = torch.where(f_sorted[:, :, None] == f_sorted[:, None, :], iou,
                          0.0)
    keep_sorted = greedy_keep(s_sorted > 0.0,
                              earlier & (iou > cfg.iou_threshold))
    final_scores = torch.where(keep_sorted, s_sorted,
                               s_sorted * cfg.suppression)
    final_keep = final_scores > cfg.instance_threshold
    return {
        'category': seed_f + 1,
        'score': torch.empty_like(final_scores).scatter_(1, order,
                                                         final_scores),
        'box': boxes,
        'keep': torch.empty_like(final_keep).scatter_(1, order, final_keep),
    }


def decode_cifdet_single(cifdet, *, stride, config):
    """:func:`decode_cifdet` of one image's fields (F, 6, H, W)."""
    return {k: v[0] for k, v in decode_cifdet(
        cifdet[None], stride=stride, config=config).items()}


def build_cifdet_decoder(*, stride, config=None):
    """The batched decode ``fn(cifdet (B, F, 6, H, W)) -> dict`` of
    ``config`` (default: :class:`CifDetDecoderConfig`)."""
    return functools.partial(decode_cifdet, stride=stride,
                             config=config or CifDetDecoderConfig())
