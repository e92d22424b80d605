"""COCO person keypoint constants.

These are public dataset-definition constants (keypoint names, skeleton
topology, OKS sigmas, canonical poses) as used by the COCO keypoint
challenge and the reference ``plugins/coco/constants.py``.
"""

import numpy as np

COCO_CATEGORIES = [
    'person', 'bicycle', 'car', 'motorcycle', 'airplane', 'bus', 'train',
    'truck', 'boat', 'traffic light', 'fire hydrant', 'stop sign',
    'parking meter', 'bench', 'bird', 'cat', 'dog', 'horse', 'sheep', 'cow',
    'elephant', 'bear', 'zebra', 'giraffe', 'backpack', 'umbrella', 'handbag',
    'tie', 'suitcase', 'frisbee', 'skis', 'snowboard', 'sports ball', 'kite',
    'baseball bat', 'baseball glove', 'skateboard', 'surfboard',
    'tennis racket', 'bottle', 'wine glass', 'cup', 'fork', 'knife', 'spoon',
    'bowl', 'banana', 'apple', 'sandwich', 'orange', 'broccoli', 'carrot',
    'hot dog', 'pizza', 'donut', 'cake', 'chair', 'couch', 'potted plant',
    'bed', 'dining table', 'toilet', 'tv', 'laptop', 'mouse', 'remote',
    'keyboard', 'cell phone', 'microwave', 'oven', 'toaster', 'sink',
    'refrigerator', 'book', 'clock', 'vase', 'scissors', 'teddy bear',
    'hair drier', 'toothbrush',
]

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

DENSER_COCO_PERSON_SKELETON = [
    (1, 2), (1, 3), (2, 3), (1, 4), (1, 5), (4, 5),
    (1, 6), (1, 7), (2, 6), (3, 7),
    (2, 4), (3, 5), (4, 6), (5, 7), (6, 7),
    (6, 12), (7, 13), (6, 13), (7, 12), (12, 13),
    (6, 8), (7, 9), (8, 10), (9, 11), (6, 10), (7, 11),
    (8, 9), (10, 11),
    (10, 12), (11, 13),
    (10, 14), (11, 15),
    (14, 12), (15, 13), (12, 15), (13, 14),
    (12, 16), (13, 17),
    (16, 14), (17, 15), (14, 17), (15, 16),
    (14, 15), (16, 17),
]

DENSER_COCO_PERSON_CONNECTIONS = [
    c for c in DENSER_COCO_PERSON_SKELETON
    if c not in COCO_PERSON_SKELETON
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

HFLIP = {
    'left_eye': 'right_eye',
    'right_eye': 'left_eye',
    'left_ear': 'right_ear',
    'right_ear': 'left_ear',
    'left_shoulder': 'right_shoulder',
    'right_shoulder': 'left_shoulder',
    'left_elbow': 'right_elbow',
    'right_elbow': 'left_elbow',
    'left_wrist': 'right_wrist',
    'right_wrist': 'left_wrist',
    'left_hip': 'right_hip',
    'right_hip': 'left_hip',
    'left_knee': 'right_knee',
    'right_knee': 'left_knee',
    'left_ankle': 'right_ankle',
    'right_ankle': 'left_ankle',
}


def cocokp_head_metas(with_dense=False):
    """The cocokp ``[cif, caf]`` head metas, and with ``with_dense`` the
    dense ``caf25`` meta of the denser skeleton's extra connections, as
    the JAX package's CocoKp data module builds them
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
    if not with_dense:
        return [cif, caf]
    dcaf = headmeta.Caf('caf25', 'cocokp',
                        keypoints=COCO_KEYPOINTS,
                        sigmas=COCO_PERSON_SIGMAS,
                        pose=COCO_UPRIGHT_POSE,
                        skeleton=DENSER_COCO_PERSON_CONNECTIONS,
                        sparse_skeleton=COCO_PERSON_SKELETON,
                        only_in_field_of_view=True)
    return [cif, caf, dcaf]
