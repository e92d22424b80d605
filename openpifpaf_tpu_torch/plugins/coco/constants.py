"""COCO person keypoint constants.

These are public dataset-definition constants (keypoint names, skeleton
topology, OKS sigmas, canonical poses) as used by the COCO keypoint
challenge and the reference ``plugins/coco/constants.py``.
"""

import numpy as np

COCO_KEYPOINTS = [
    'nose',
    'left_eye',
    'right_eye',
    'left_ear',
    'right_ear',
    'left_shoulder',
    'right_shoulder',
    'left_elbow',
    'right_elbow',
    'left_wrist',
    'right_wrist',
    'left_hip',
    'right_hip',
    'left_knee',
    'right_knee',
    'left_ankle',
    'right_ankle',
]

COCO_PERSON_SKELETON = [
    (16, 14), (14, 12), (17, 15), (15, 13), (12, 13), (6, 12), (7, 13),
    (6, 7), (6, 8), (7, 9), (8, 10), (9, 11), (2, 3), (1, 2), (1, 3),
    (2, 4), (3, 5), (4, 6), (5, 7),
]

COCO_PERSON_SIGMAS = [
    0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072, 0.072,
    0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089, 0.089,
]

COCO_PERSON_SCORE_WEIGHTS = [3.0] * 3 + [1.0] * (len(COCO_KEYPOINTS) - 3)

COCO_UPRIGHT_POSE = np.array([
    [0.0, 9.3, 2.0],     # nose
    [-0.35, 9.7, 2.0],   # left_eye
    [0.35, 9.7, 2.0],    # right_eye
    [-0.7, 9.5, 2.0],    # left_ear
    [0.7, 9.5, 2.0],     # right_ear
    [-1.4, 8.0, 2.0],    # left_shoulder
    [1.4, 8.0, 2.0],     # right_shoulder
    [-1.75, 6.0, 2.0],   # left_elbow
    [1.75, 6.2, 2.0],    # right_elbow
    [-1.75, 4.0, 2.0],   # left_wrist
    [1.75, 4.2, 2.0],    # right_wrist
    [-1.26, 4.0, 2.0],   # left_hip
    [1.26, 4.0, 2.0],    # right_hip
    [-1.4, 2.0, 2.0],    # left_knee
    [1.4, 2.1, 2.0],     # right_knee
    [-1.4, 0.0, 2.0],    # left_ankle
    [1.4, 0.1, 2.0],     # right_ankle
])

def cocokp_head_metas():
    """The cocokp ``[cif, caf]`` head metas, as the JAX package's CocoKp
    data module builds them without ``with_dense``
    (``plugins/coco/cocokp.py:56-79`` of ``openpifpaf_tpu``)."""
    from ... import headmeta

    cif = headmeta.Cif('cif', 'cocokp',
                       keypoints=COCO_KEYPOINTS,
                       sigmas=COCO_PERSON_SIGMAS,
                       pose=COCO_UPRIGHT_POSE,
                       draw_skeleton=COCO_PERSON_SKELETON,
                       score_weights=COCO_PERSON_SCORE_WEIGHTS)
    caf = headmeta.Caf('caf', 'cocokp',
                       keypoints=COCO_KEYPOINTS,
                       sigmas=COCO_PERSON_SIGMAS,
                       pose=COCO_UPRIGHT_POSE,
                       skeleton=COCO_PERSON_SKELETON)
    return [cif, caf]
