"""Keypoint NMS over decoded poses with an occupancy grid (port of
``openpifpaf_tpu/ops/nms.py``: ``nms_keypoints`` and
``pose_score_uniform``).

Annotations are processed in descending score order; joints that land on
an occupied cell are suppressed (v *= 1e-5), surviving joints mark a
square window. Then joints below the keypoint threshold are zeroed and
annotations below the instance threshold dropped. The sequential loop is
a per-field pairwise relation whose acceptance closure is a fixpoint,
iterated here with a host-side "changed?" test.
"""

import torch

from .seeds import _fixpoint, _grid_shape, _query_cell, _window


def pose_score_uniform(poses):
    """UniformScore: mean confidence over all joints."""
    return torch.mean(poses[..., 0], dim=-1)


def nms_keypoints(poses, hr_shape, *, suppression=1e-5,
                  instance_threshold=0.15, keypoint_threshold=0.15,
                  occupancy_reduction=2.0, occupancy_min_scale=4.0):
    """poses: (K, n_kp, 4) [v, x, y, s] in hi-res pixels.

    Returns (poses_out, keep, order): suppressed and thresholded poses in
    the original order, (K,) bool of annotations above the instance
    threshold, and (K,) indices sorting poses by final score descending.
    """
    k = poses.shape[0]
    gh, gw = _grid_shape(hr_shape, occupancy_reduction)
    min_scale_reduced = occupancy_min_scale / occupancy_reduction

    sort_order = torch.argsort(-pose_score_uniform(poses), stable=True)
    sorted_poses = poses[sort_order]

    v = sorted_poses[:, :, 0]                                 # (K, n_kp)
    x = sorted_poses[:, :, 1] / occupancy_reduction
    y = sorted_poses[:, :, 2] / occupancy_reduction
    sigma = torch.clamp_min(sorted_poses[:, :, 3] / occupancy_reduction,
                            min_scale_reduced)
    xi, yi = _query_cell(x, y, gh, gw)
    minx, maxx, miny, maxy = _window(x, y, sigma, gh, gw)

    # covers[f, i, j]: would accepted joint f of (sorted) pose i suppress
    # joint f of the later pose j?
    active = v > 0.0
    rank = torch.arange(k, device=poses.device)
    covers = (active.T[:, :, None]
              & (xi.T[:, None, :] >= minx.T[:, :, None])
              & (xi.T[:, None, :] < maxx.T[:, :, None])
              & (yi.T[:, None, :] >= miny.T[:, :, None])
              & (yi.T[:, None, :] < maxy.T[:, :, None])
              & (rank[:, None] < rank[None, :])[None])      # (n_kp, K, K)
    accepted = _fixpoint(
        lambda accept: active.T & ~torch.any(accept[:, :, None] & covers,
                                             dim=1),
        active.T)                                           # (n_kp, K)

    v_new = torch.where(active & ~accepted.T, v * suppression, v)
    v_new = torch.where(v_new > keypoint_threshold, v_new, 0.0)
    out_sorted = sorted_poses.clone()
    out_sorted[:, :, 0] = v_new
    keep_sorted = pose_score_uniform(out_sorted) >= instance_threshold

    inverse = torch.argsort(sort_order, stable=True)
    poses_out = out_sorted[inverse]
    keep = keep_sorted[inverse]
    final_scores = torch.where(keep, pose_score_uniform(poses_out),
                               -torch.inf)
    order = torch.argsort(-final_scores, stable=True)
    return poses_out, keep, order
