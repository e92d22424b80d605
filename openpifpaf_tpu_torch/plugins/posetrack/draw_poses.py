"""Render the posetrack/tracking skeleton diagrams (copy of
``openpifpaf_tpu/plugins/posetrack/draw_poses.py``).

Produces the documentation figures: the posetrack-2018 skeleton, the
two-frame tracking skeletons (full and forward-only), and the COCO
forward tracking skeleton, plus a combined overview panel.

Run: ``python -m openpifpaf_tpu_torch.plugins.posetrack.draw_poses [outdir]``
"""

import os
import sys

import numpy as np

from ... import show
from ...annotation import Annotation
from ..coco import constants as coco
from . import constants as pt


def _pose_scale(pose):
    spread_x = np.max(pose[:, 0]) - np.min(pose[:, 0])
    spread_y = np.max(pose[:, 1]) - np.min(pose[:, 1])
    return np.sqrt(spread_x * spread_y)


def _two_frame(pose, sigmas):
    """Duplicate a canonical pose into a slightly displaced past frame."""
    poses = np.concatenate([pose, 0.9 * pose + np.array([-1.5, 1.5, 0.0])])
    scales = np.concatenate([sigmas, 0.8 * sigmas])
    return poses, scales


def _cross_frame_edges(n_kp):
    return [(j, j + n_kp) for j in range(1, n_kp + 1)]


def skeleton_figures():
    """(name, Annotation) pairs for every documentation figure."""
    scale = _pose_scale(pt.UPRIGHT_POSE)
    sigmas = np.array(pt.SIGMAS) * scale
    pose2, sigmas2 = _two_frame(pt.UPRIGHT_POSE, sigmas)
    n_kp = len(pt.KEYPOINTS)

    coco_sigmas = np.array(coco.COCO_PERSON_SIGMAS) * scale
    coco_pose2, coco_sigmas2 = _two_frame(coco.COCO_UPRIGHT_POSE,
                                          coco_sigmas)

    specs = [
        ('skeleton_posetrack', pt.KEYPOINTS, pt.SKELETON,
         pt.UPRIGHT_POSE, sigmas),
        ('skeleton_tracking', pt.KEYPOINTS * 2,
         (np.array(pt.SKELETON) + n_kp).tolist()
         + _cross_frame_edges(n_kp) + list(pt.SKELETON),
         pose2, sigmas2),
        ('skeleton_tracking_forward', pt.KEYPOINTS * 2,
         _cross_frame_edges(n_kp) + list(pt.SKELETON),
         pose2, sigmas2),
        ('coco_skeleton_forward', coco.COCO_KEYPOINTS * 2,
         _cross_frame_edges(17) + list(coco.COCO_PERSON_SKELETON),
         coco_pose2, coco_sigmas2),
    ]

    out = []
    for name, keypoints, skeleton, pose, joint_scales in specs:
        ann = Annotation(keypoints, skeleton)
        ann.set(pose, joint_scales, fixed_score='')
        out.append((name, ann))
    return out


def main(outdir='docs'):
    show.KeypointPainter.show_joint_scales = True
    show.KeypointPainter.line_width = 6
    show.KeypointPainter.monocolor_connections = False
    painter = show.KeypointPainter()

    figures = skeleton_figures()
    os.makedirs(outdir, exist_ok=True)
    for name, ann in figures:
        with show.Canvas.annotation(
                ann, filename=os.path.join(outdir, f'{name}.png')) as ax:
            painter.annotation(ax, ann)

    with show.Canvas.blank(os.path.join(outdir, 'skeleton_overview.png'),
                           figsize=(12, 6), ncols=len(figures)) as axes:
        for ax, (_, ann) in zip(axes, figures):
            ax.set_axis_off()
            ax.set_aspect('equal')
            painter.annotation(ax, ann)


if __name__ == '__main__':
    main(*sys.argv[1:2])
