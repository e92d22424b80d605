"""PoseTrack dataset constants (copy of
``openpifpaf_tpu/plugins/posetrack/constants.py``)."""

import numpy as np

KEYPOINTS = [
    'nose',
    'head_bottom',
    'head_top',
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

SIGMAS = [
    0.026,  # nose
    0.08,   # head_bottom (changed versus COCO)
    0.06,   # head_top (changed versus COCO)
    0.035,  # ears (never annotated)
    0.035,  # ears (never annotated)
    0.079, 0.079,  # shoulders
    0.072, 0.072,  # elbows
    0.062, 0.062,  # wrists
    0.107, 0.107,  # hips
    0.087, 0.087,  # knees
    0.089, 0.089,  # ankles
]

UPRIGHT_POSE = np.array([
    [0.2, 9.3, 2.0],     # nose
    [-0.05, 9.0, 2.0],   # head_bottom
    [0.05, 10.0, 2.0],   # head_top
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

SKELETON = [
    (16, 14), (14, 12), (17, 15), (15, 13), (12, 13), (6, 12), (7, 13),
    (6, 8), (7, 9), (8, 10), (9, 11), (2, 6), (2, 7), (2, 3), (1, 2),
    (1, 3), (1, 4), (1, 5),
]

DENSER_CONNECTIONS = [
    (6, 7), (8, 9), (10, 11), (14, 15), (16, 17),
    (6, 10), (7, 11), (10, 12), (11, 13), (2, 10), (2, 11),
    (12, 15), (13, 14), (14, 17), (15, 16), (6, 13), (7, 12),
    (6, 3), (7, 3), (6, 1), (7, 1), (8, 2), (9, 2),
]

HFLIP = {
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

CATEGORIES = ['person']
