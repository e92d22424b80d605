"""Pose growth (port of ``openpifpaf_tpu/ops/grow.py``).

The reference grows one pose at a time from a priority-queue frontier.
Because a connection value depends only on its committed (hence fixed)
source joint, that lazy best-first loop equals: evaluate every frontier
edge, commit the global argmax, repeat. Poses for all seeds grow at once,
with the lanes as a batch dimension. Each of JAX's ``while_loop``s runs
here as a fixed number of masked steps with no host sync: a lane that
stops changing the loop's state computes the same step again and changes
nothing, so the extra steps are no-ops and a step index is JAX's ``step``
for as long as the lane is alive. Every step writes one slot per lane.
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


def grow_connection_blend(caf, d, x, y, s, *, filter_sigmas=1.0,
                          only_max=False):
    """Blend of the top-2 candidates of directed edge ``d`` near the source
    (x, y) with scale ``s`` (``cifcaf.cpp:32-103``; JAX's
    ``grow_connection_blend``): :func:`blend_batch` of that one edge.
    caf: dict of (2E, C) candidate planes. Returns (v, tx, ty, ts), 0-d
    tensors."""
    planes = [caf[k][d] for k in _PLANES]
    return blend_batch(*planes, torch.as_tensor(x), torch.as_tensor(y),
                       torch.as_tensor(s), filter_sigmas=filter_sigmas,
                       only_max=only_max)


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


def connection_value(planes, planes_rev, pose, d, dir_start, *,
                     keypoint_threshold, keypoint_threshold_rel,
                     reverse_match, filter_sigmas, only_max):
    """The value (L, 4) [v, x, y, s] of directed edge ``d[l]`` for each lane
    l of poses (L, n_kp, 4): JAX's ``connection_value`` on
    ``grow_connection_blend``, the greedy loop's scoring of one edge per
    lane (top-2 argmax of that edge's candidates, blend, geometric mean,
    thresholds, reverse match). Unlike :func:`_connection_values` it has no
    guard on the source joint's score."""
    lanes = torch.arange(pose.shape[0], device=pose.device)
    sv, sx, sy, ss = pose[lanes, dir_start[d]].unbind(-1)
    nv, nx, ny, ns = blend_batch(*planes[:, d], sx, sy, ss,
                                 filter_sigmas=filter_sigmas,
                                 only_max=only_max)
    v = torch.sqrt(nv * sv)
    ok = ((nv > 0.0) & (v >= keypoint_threshold)
          & (v >= sv * keypoint_threshold_rel))
    if reverse_match:
        rv, rx, ry, _ = blend_batch(*planes_rev[:, d], nx, ny, ns,
                                    filter_sigmas=filter_sigmas,
                                    only_max=only_max)
        ok = ok & (rv > 0.0) & (torch.abs(sx - rx) + torch.abs(sy - ry)
                                <= ss)
    return torch.stack([torch.where(ok, v, 0.0), nx, ny, ns], dim=-1)


def grow_from_pose(caf, graph: SkeletonGraph, pose0, *,
                   keypoint_threshold=0.15, keypoint_threshold_rel=0.5,
                   reverse_match=True, filter_sigmas=1.0, greedy=False,
                   only_max=False, block_joints=False, record_order=False):
    """Grow (L, n_keypoints, 4) partial poses [v, x, y, s] to completion;
    joints with v > 0 are fixed and form the initial frontier.

    Non-greedy: a cache holds every directed edge's connection value; each
    of ``n_keypoints`` steps commits the best frontier edge of every lane
    and re-evaluates the edges leaving the new joint (a committed joint is
    immutable, so the cache stays exact). Greedy (``cifcaf.cpp:298-307``):
    each of ``n_keypoints + 2E`` steps takes the frontier edge of the best
    source score, evaluates it alone (:func:`connection_value`) and commits
    it, or marks it failed; a step commits a joint or fails an edge, so
    that many steps cover the JAX loop.

    ``block_joints`` (``--cifcaf-block-joints``) marks unreachable frontier
    targets with v = 1e-5 at (0, 0). ``record_order`` also returns
    (commit_edge, commit_step), (L, n_keypoints) int64: for each joint the
    directed edge that committed it and the step, -1 where none did.
    """
    n_lanes, n_kp, _ = pose0.shape
    n_dir = 2 * graph.n_edges
    dev = pose0.device
    kw = dict(keypoint_threshold=keypoint_threshold,
              keypoint_threshold_rel=keypoint_threshold_rel,
              reverse_match=reverse_match, filter_sigmas=filter_sigmas,
              only_max=only_max)

    dir_start = torch.as_tensor(graph.dir_start, device=dev)
    dir_end = torch.as_tensor(graph.dir_end, device=dev)
    dir_reverse = torch.as_tensor(graph.dir_reverse, device=dev)
    planes = torch.stack([caf[k] for k in _PLANES])      # (6, n_dir, C)
    planes_rev = planes[:, dir_reverse]
    lanes = torch.arange(n_lanes, device=dev)

    pose = pose0.clone()
    commit_edge = torch.full((n_lanes, n_kp), -1, dtype=torch.int64,
                             device=dev)
    commit_step = commit_edge.clone()

    def commit(step, edge, joint, ok):
        """Record ``edge`` at ``step`` for the lanes that ``ok`` marks, one
        write per lane."""
        if record_order:
            commit_edge[lanes, joint] = torch.where(
                ok, edge, commit_edge[lanes, joint])
            commit_step[lanes, joint] = torch.where(
                ok, step, commit_step[lanes, joint])

    if greedy:
        failed = torch.zeros((n_lanes, n_dir), dtype=torch.bool, device=dev)
        for step in range(n_kp + n_dir):
            active = ((pose[:, dir_end, 0] == 0.0)
                      & (pose[:, dir_start, 0] > 0.0) & ~failed)
            priority = torch.where(active, torch.sqrt(pose[:, dir_start, 0]),
                                   -1.0)
            best = torch.argmax(priority, dim=1)         # (L,)
            any_active = priority[lanes, best] > 0.0
            vals = connection_value(planes, planes_rev, pose, best,
                                    dir_start, **kw)
            success = any_active & (vals[:, 0] > 0.0)
            joint = dir_end[best]
            pose[lanes, joint] = torch.where(success[:, None], vals,
                                             pose[lanes, joint])
            failed[lanes, best] |= any_active & ~success
            commit(step, best, joint, success)
    else:
        adjacency = torch.as_tensor(graph.adjacency, device=dev)
        adjacency_valid = torch.as_tensor(graph.adjacency_valid, device=dev)
        lane_idx = lanes[:, None].expand(n_lanes, adjacency.shape[1])
        src = pose[:, dir_start]                         # (L, n_dir, 4)
        # slot n_dir is a dump row: it takes the writes of padded adjacency
        # entries and of lanes that commit nothing, so that no real slot is
        # written twice in one scatter
        cache = torch.cat([
            _connection_values(planes, planes_rev, *src.unbind(-1), **kw),
            torch.zeros((n_lanes, 1, 4), dtype=pose.dtype, device=dev)],
            dim=1)

        for step in range(n_kp):
            target_empty = pose[:, dir_end, 0] == 0.0
            cand = torch.where(target_empty, cache[:, :n_dir, 0], 0.0)
            best = torch.argmax(cand, dim=1)             # (L,)
            ok = cand[lanes, best] > 0.0
            new_joint = dir_end[best]
            # one write per lane: a lane that commits nothing writes back
            # the joint it holds
            joint = torch.where(ok[:, None], cache[lanes, best],
                                pose[lanes, new_joint])
            pose[lanes, new_joint] = joint
            commit(step, best, new_joint, ok)

            # re-evaluate the edges leaving each lane's new joint
            edges = adjacency[new_joint]                 # (L, deg)
            update = adjacency_valid[new_joint] & ok[:, None]
            src = joint[:, None, :].expand(n_lanes, edges.shape[1], 4)
            vals = _connection_values(planes[:, edges], planes_rev[:, edges],
                                      *src.unbind(-1), **kw)
            cache[lane_idx, torch.where(update, edges, n_dir)] = vals

    if block_joints:
        pose = _apply_block_joints(pose, dir_start, dir_end)
    if record_order:
        return pose, commit_edge, commit_step
    return pose


def _apply_block_joints(pose, dir_start, dir_end):
    """Empty joints that a filled joint's edge reaches get v = 1e-5 at
    (0, 0) (``cifcaf.cpp:291-295``, applied at convergence)."""
    marks = torch.zeros(pose.shape[:2], dtype=torch.int32,
                        device=pose.device)
    marks.index_add_(1, dir_end,
                     (pose[:, dir_start, 0] > 0.0).to(torch.int32))
    blocked = (marks > 0) & (pose[:, :, 0] == 0.0)
    mark = torch.tensor([1e-5, 0.0, 0.0, 0.0], dtype=pose.dtype,
                        device=pose.device)
    return torch.where(blocked[..., None], mark, pose)


def _grow_masked(caf, graph, pose0, live, **kwargs):
    """:func:`grow_from_pose` on the lanes ``live`` of (K, n_kp, 4) start
    poses; the other lanes give zeros (and -1 commits). Every lane grows
    and the dead ones are zeroed, as JAX does: no shape depends on the
    data and nothing is read on the host, so ``torch.export`` traces it."""
    grown = grow_from_pose(caf, graph, pose0, **kwargs)
    record = kwargs.get('record_order', False)
    out = tuple(torch.where(live.view(-1, *[1] * (a.dim() - 1)), a,
                            0 if a.is_floating_point() else -1)
                for a in (grown if record else (grown,)))
    return out if record else out[0]


def _grow_compact(caf, graph, pose0, live, **kwargs):
    """:func:`_grow_masked`'s result from the live lanes alone, gathered
    with ``torch.nonzero`` (a shape that depends on the data, read on the
    host). Lanes grow independently, so both give the same bits."""
    record = kwargs.get('record_order', False)
    poses = torch.zeros_like(pose0)
    order = torch.full((pose0.shape[0], graph.n_keypoints), -1,
                       dtype=torch.int64, device=pose0.device)
    out = (poses, order, order.clone())
    live = torch.nonzero(live).flatten()
    if live.numel():
        grown = grow_from_pose(caf, graph, pose0[live], **kwargs)
        for full, part in zip(out, grown if record else (grown,)):
            full[live] = part
    return out if record else poses


def _grow_live(caf, graph, pose0, live, **kwargs):
    """The growth of the live lanes: compact when run eagerly, where a
    decode with few or no live lanes then skips most or all of the
    growth's launches (growing every lane made random-weight decodes
    8-30x slower on the H100, ``chip_smoke.py`` phases 13c and 15c-e);
    masked in a program that ``torch.export`` traces, where no shape may
    depend on the data."""
    if torch.compiler.is_exporting():
        return _grow_masked(caf, graph, pose0, live, **kwargs)
    return _grow_compact(caf, graph, pose0, live, **kwargs)


def grow_poses(caf, graph: SkeletonGraph, seeds, **kwargs):
    """One pose per seed (dict of equal-length tensors f, v, x, y, s).
    Seeds with v == 0 give all-zero poses; only the others are grown.
    With ``record_order`` returns (poses, commit_edge, commit_step)."""
    n = seeds['v'].shape[0]
    dev = seeds['v'].device
    pose0 = torch.zeros((n, graph.n_keypoints, 4), dtype=torch.float32,
                        device=dev)
    pose0[torch.arange(n, device=dev), seeds['f']] = \
        torch.stack([seeds[k] for k in ('v', 'x', 'y', 's')], dim=-1)
    return _grow_live(caf, graph, pose0, seeds['v'] > 0.0, **kwargs)


def grow_from_poses(caf, graph: SkeletonGraph, poses, **kwargs):
    """:func:`grow_from_pose` on (K, n_kp, 4) initial poses; lanes with no
    filled joint give zeros. With ``record_order`` returns (poses,
    commit_edge, commit_step)."""
    return _grow_live(caf, graph, poses,
                      torch.any(poses[:, :, 0] > 0.0, dim=1), **kwargs)


def flood_fill_poses(graph: SkeletonGraph, poses):
    """Copy filled joints into their empty neighbours with v = 1e-5
    (``cifcaf.cpp:429-449``), in descending source-score order, for each
    of the (K, n_kp, 4) poses: ``n_kp`` masked steps that each fill at
    most one joint per pose."""
    dev = poses.device
    dir_start = torch.as_tensor(graph.dir_start, device=dev)
    dir_end = torch.as_tensor(graph.dir_end, device=dev)
    lanes = torch.arange(poses.shape[0], device=dev)
    poses = poses.clone()
    for _ in range(graph.n_keypoints):
        active = (poses[:, dir_end, 0] == 0.0) & (poses[:, dir_start, 0] > 0.0)
        priority = torch.where(active, torch.sqrt(poses[:, dir_start, 0]),
                               -1.0)
        best = torch.argmax(priority, dim=1)
        any_active = priority[lanes, best] > 0.0
        src = poses[lanes, dir_start[best]]
        new = torch.cat([torch.full_like(src[:, :1], 1e-5), src[:, 1:]],
                        dim=1)
        joint = dir_end[best]
        poses[lanes, joint] = torch.where(any_active[:, None], new,
                                          poses[lanes, joint])
    return poses


def flood_fill_pose(graph: SkeletonGraph, pose):
    """:func:`flood_fill_poses` of one (n_kp, 4) pose."""
    return flood_fill_poses(graph, pose[None])[0]
