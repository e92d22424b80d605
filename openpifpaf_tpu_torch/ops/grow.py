"""Pose growth (port of ``openpifpaf_tpu/ops/grow.py``: ``SkeletonGraph``,
``make_skeleton_graph``, ``blend_batch``, the non-greedy
``grow_from_pose`` and ``grow_poses``).

The reference grows one pose at a time from a priority-queue frontier.
Because a connection value depends only on its committed (hence fixed)
source joint, that lazy best-first loop equals: evaluate every frontier
edge, commit the global argmax, repeat. Poses for all seeds grow at once,
with the lanes as a batch dimension. A lane whose best frontier value is
0 changes nothing from then on, so exactly ``n_keypoints`` masked steps
over all lanes give the JAX ``while_loop``'s result without a host sync.
"""

from typing import NamedTuple

import numpy as np
import torch


class SkeletonGraph(NamedTuple):
    """Static directed-edge structure derived from a skeleton.

    Directed edge d in [0, E) is forward on edge d; d in [E, 2E) backward.
    ``adjacency`` lists the directed edges starting at each joint,
    (n_keypoints, max_degree) padded, with ``adjacency_valid`` flags.
    """
    n_keypoints: int
    n_edges: int
    dir_start: np.ndarray   # (2E,) int64
    dir_end: np.ndarray     # (2E,) int64
    dir_reverse: np.ndarray  # (2E,) int64
    adjacency: np.ndarray   # (n_keypoints, max_degree) int64
    adjacency_valid: np.ndarray  # (n_keypoints, max_degree) bool


def make_skeleton_graph(n_keypoints, skeleton) -> SkeletonGraph:
    skeleton = np.asarray(skeleton, dtype=np.int64)
    n_edges = len(skeleton)
    j1 = skeleton[:, 0] - 1
    j2 = skeleton[:, 1] - 1
    dir_start = np.concatenate([j1, j2])
    dir_end = np.concatenate([j2, j1])
    dir_reverse = np.concatenate([np.arange(n_edges) + n_edges,
                                  np.arange(n_edges)])

    degree = np.bincount(dir_start, minlength=n_keypoints)
    max_degree = int(degree.max()) if len(degree) else 1
    adjacency = np.zeros((n_keypoints, max_degree), dtype=np.int64)
    adjacency_valid = np.zeros((n_keypoints, max_degree), dtype=bool)
    fill = np.zeros(n_keypoints, dtype=np.int64)
    for d, s in enumerate(dir_start):
        adjacency[s, fill[s]] = d
        adjacency_valid[s, fill[s]] = True
        fill[s] += 1
    return SkeletonGraph(n_keypoints, n_edges, dir_start, dir_end,
                         dir_reverse, adjacency, adjacency_valid)


def blend_batch(cc, sx, sy, tx, ty, ts, x, y, s, *, filter_sigmas=1.0,
                only_max=False):
    """Top-2 candidate blend batched over directed edges
    (``cifcaf.cpp:32-103`` of the reference).

    Candidate tensors: (..., D, C); x, y, s: (..., D), broadcasting against
    them. Returns (v, tx, ty, ts), each (..., D).
    """
    x = x[..., None]
    y = y[..., None]
    s = s[..., None]

    xy_scale = torch.clamp_min(s, 0.5)
    sigma_filter = filter_sigmas * xy_scale / 2.0
    sigma2 = 0.25 * xy_scale * xy_scale

    dx = sx - x
    dy = sy - y
    keep = ((cc > 0.0)
            & (torch.abs(dx) <= sigma_filter)
            & (torch.abs(dy) <= sigma_filter))
    d2 = dx * dx + dy * dy
    score = torch.where(keep, torch.exp(-0.5 * d2 / sigma2) * cc, 0.0)

    shape = score.shape

    def pick(a, i):
        return torch.gather(a.expand(shape), -1, i[..., None])[..., 0]

    i1 = torch.argmax(score, dim=-1)
    score_1 = pick(score, i1)
    others = score.scatter(-1, i1[..., None], 0.0)
    i2 = torch.argmax(others, dim=-1)
    score_2 = pick(others, i2)

    e1x, e1y = pick(tx, i1), pick(ty, i1)
    e1s = torch.clamp_min(pick(ts, i1), 0.0)
    e2x, e2y = pick(tx, i2), pick(ty, i2)
    e2s = torch.clamp_min(pick(ts, i2), 0.0)

    if only_max:
        v = score_1
        ox, oy, os_ = e1x, e1y, e1s
    else:
        blend_d2 = (e1x - e2x) ** 2 + (e1y - e2y) ** 2
        use_single = ((score_2 < 0.01)
                      | (score_2 < 0.5 * score_1)
                      | (blend_d2 > (e1s ** 2) / 4.0))
        total = score_1 + score_2
        denom = torch.clamp_min(total, 1e-12)
        bx = (score_1 * e1x + score_2 * e2x) / denom
        by = (score_1 * e1y + score_2 * e2y) / denom
        bs = (score_1 * e1s + score_2 * e2s) / denom
        v = torch.where(use_single, 0.5 * score_1, 0.5 * total)
        ox = torch.where(use_single, e1x, bx)
        oy = torch.where(use_single, e1y, by)
        os_ = torch.where(use_single, e1s, bs)

    invalid = score_1 == 0.0
    return tuple(torch.where(invalid, 0.0, a) for a in (v, ox, oy, os_))


#: candidate planes, in the order of :func:`blend_batch`'s arguments
_PLANES = ('c', 'sx', 'sy', 'tx', 'ty', 'ts')


def _connection_values(planes, planes_rev, sv, sx, sy, ss, *,
                       keypoint_threshold, keypoint_threshold_rel,
                       reverse_match, filter_sigmas, only_max):
    """Connection values (..., D, 4) for candidate planes (6, ..., D, C)
    with source joints (sv, sx, sy, ss) of shape (..., D): forward blend,
    geometric-mean score, absolute and relative thresholds, reverse-match
    check."""
    nv, nx, ny, ns = blend_batch(*planes, sx, sy, ss,
                                 filter_sigmas=filter_sigmas,
                                 only_max=only_max)

    v = torch.sqrt(nv * sv)
    ok = ((nv > 0.0) & (v >= keypoint_threshold)
          & (v >= sv * keypoint_threshold_rel))
    if reverse_match:
        rv, rx, ry, _ = blend_batch(*planes_rev, nx, ny, ns,
                                    filter_sigmas=filter_sigmas,
                                    only_max=only_max)
        ok = ok & (rv > 0.0) & (torch.abs(sx - rx) + torch.abs(sy - ry)
                                <= ss)
    v = torch.where(ok & (sv > 0.0), v, 0.0)
    return torch.stack([v, nx, ny, ns], dim=-1)


def grow_from_pose(caf, graph: SkeletonGraph, pose0, *,
                   keypoint_threshold=0.15, keypoint_threshold_rel=0.5,
                   reverse_match=True, filter_sigmas=1.0, only_max=False):
    """Grow (L, n_keypoints, 4) partial poses [v, x, y, s] to completion;
    joints with v > 0 are fixed and form the initial frontier.

    Non-greedy: a cache holds every directed edge's connection value; each
    step commits the best frontier edge of every lane and re-evaluates the
    edges leaving the new joint (a committed joint is immutable, so the
    cache stays exact). The loop has no host sync: every step writes one
    joint per lane and a fixed number of cache slots per lane.
    """
    n_lanes = pose0.shape[0]
    n_dir = 2 * graph.n_edges
    dev = pose0.device
    kw = dict(keypoint_threshold=keypoint_threshold,
              keypoint_threshold_rel=keypoint_threshold_rel,
              reverse_match=reverse_match, filter_sigmas=filter_sigmas,
              only_max=only_max)

    dir_start = torch.as_tensor(graph.dir_start, device=dev)
    dir_end = torch.as_tensor(graph.dir_end, device=dev)
    dir_reverse = torch.as_tensor(graph.dir_reverse, device=dev)
    adjacency = torch.as_tensor(graph.adjacency, device=dev)
    adjacency_valid = torch.as_tensor(graph.adjacency_valid, device=dev)
    planes = torch.stack([caf[k] for k in _PLANES])      # (6, n_dir, C)
    planes_rev = planes[:, dir_reverse]
    lanes = torch.arange(n_lanes, device=dev)
    lane_idx = lanes[:, None].expand(n_lanes, adjacency.shape[1])

    pose = pose0.clone()
    src = pose[:, dir_start]                             # (L, n_dir, 4)
    # slot n_dir is a dump row: it takes the writes of padded adjacency
    # entries and of lanes that commit nothing, so that no real slot is
    # written twice in one scatter
    cache = torch.cat([
        _connection_values(planes, planes_rev, *src.unbind(-1), **kw),
        torch.zeros((n_lanes, 1, 4), dtype=pose.dtype, device=dev)], dim=1)

    for _ in range(graph.n_keypoints):
        target_empty = pose[:, dir_end, 0] == 0.0
        cand = torch.where(target_empty, cache[:, :n_dir, 0], 0.0)
        best = torch.argmax(cand, dim=1)                 # (L,)
        commit = cand[lanes, best] > 0.0
        new_joint = dir_end[best]
        # one write per lane: a lane that commits nothing writes back the
        # joint it holds
        joint = torch.where(commit[:, None], cache[lanes, best],
                            pose[lanes, new_joint])
        pose[lanes, new_joint] = joint

        # re-evaluate the edges leaving each lane's new joint
        edges = adjacency[new_joint]                     # (L, deg)
        update = adjacency_valid[new_joint] & commit[:, None]
        src = joint[:, None, :].expand(n_lanes, edges.shape[1], 4)
        vals = _connection_values(planes[:, edges], planes_rev[:, edges],
                                  *src.unbind(-1), **kw)
        cache[lane_idx, torch.where(update, edges, n_dir)] = vals
    return pose


def grow_poses(caf, graph: SkeletonGraph, seeds, **kwargs):
    """One pose per seed (dict of equal-length tensors f, v, x, y, s).
    Seeds with v == 0 give all-zero poses; only the others are grown."""
    n = seeds['v'].shape[0]
    dev = seeds['v'].device
    poses = torch.zeros((n, graph.n_keypoints, 4), dtype=torch.float32,
                        device=dev)
    live = torch.nonzero(seeds['v'] > 0.0).flatten()
    if live.numel() == 0:
        return poses
    pose0 = torch.zeros((live.numel(), graph.n_keypoints, 4),
                        dtype=torch.float32, device=dev)
    pose0[torch.arange(live.numel(), device=dev), seeds['f'][live]] = \
        torch.stack([seeds[k][live] for k in ('v', 'x', 'y', 's')], dim=-1)
    poses[live] = grow_from_pose(caf, graph, pose0, **kwargs)
    return poses
