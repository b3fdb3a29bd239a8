"""Robot description tables: keypoints, joints, initial joint angles.

A copy of the values in `horopose_tpu/constants.py` that the serving and
training paths need (facts about the DREAM benchmark robots).
"""

from __future__ import annotations

import numpy as np

KEYPOINT_NAMES = {
    "panda": [
        "panda_link0", "panda_link2", "panda_link3", "panda_link4",
        "panda_link6", "panda_link7", "panda_hand",
    ],
    "kuka": [
        "iiwa7_link_0", "iiwa7_link_1", "iiwa7_link_2", "iiwa7_link_3",
        "iiwa7_link_4", "iiwa7_link_5", "iiwa7_link_6", "iiwa7_link_7",
    ],
    "baxter": [
        "torso_t0", "right_s0", "left_s0", "right_s1", "left_s1",
        "right_e0", "left_e0", "right_e1", "left_e1", "right_w0", "left_w0",
        "right_w1", "left_w1", "right_w2", "left_w2", "right_hand", "left_hand",
    ],
    "owi535": ["Rotation", "Base", "Elbow", "Wrist"],
}

LINK_NAMES = {
    "panda": ["panda_link0", "panda_link2", "panda_link3", "panda_link4",
              "panda_link6", "panda_link7", "panda_hand"],
    "kuka": ["iiwa_link_0", "iiwa_link_1", "iiwa_link_2", "iiwa_link_3",
             "iiwa_link_4", "iiwa_link_5", "iiwa_link_6", "iiwa_link_7"],
    "baxter": ["torso", "right_upper_shoulder", "left_upper_shoulder",
               "right_lower_shoulder", "left_lower_shoulder",
               "right_upper_elbow", "left_upper_elbow",
               "right_lower_elbow", "left_lower_elbow",
               "right_upper_forearm", "left_upper_forearm",
               "right_lower_forearm", "left_lower_forearm",
               "right_wrist", "left_wrist", "right_hand", "left_hand"],
    "owi535": ["Rotation", "Base", "Elbow", "Wrist"],
}

# baxter keypoint: the joint whose origin defines it, per keypoint name
BAXTER_KEYPOINT_JOINTS = [
    "torso_t0", "right_s0", "left_s0", "right_s1", "left_s1",
    "right_e0", "left_e0", "right_e1", "left_e1", "right_w0", "left_w0",
    "right_w1", "left_w1", "right_w2", "left_w2", "right_hand", "left_hand",
]

JOINT_NAMES = {
    "panda": ["panda_joint1", "panda_joint2", "panda_joint3", "panda_joint4",
              "panda_joint5", "panda_joint6", "panda_joint7",
              "panda_finger_joint1"],
    "kuka": ["iiwa_joint_1", "iiwa_joint_2", "iiwa_joint_3", "iiwa_joint_4",
             "iiwa_joint_5", "iiwa_joint_6", "iiwa_joint_7"],
    "baxter": ["head_pan", "right_s0", "left_s0", "right_s1", "left_s1",
               "right_e0", "left_e0", "right_e1", "left_e1", "right_w0",
               "left_w0", "right_w1", "left_w1", "right_w2", "left_w2"],
    "owi535": ["Rotation", "Base", "Elbow", "Wrist"],
}

DOF = {"panda": 8, "kuka": 7, "baxter": 15, "owi535": 4}
NUM_KEYPOINTS = {k: len(v) for k, v in KEYPOINT_NAMES.items()}

# the keypoint whose visibility decides each joint's validity, per joint of
# JOINT_NAMES (the joint-valid mask of the training ground truth)
JOINT_TO_KP = {
    "panda": [1, 1, 2, 3, 4, 4, 5, 6],
    "kuka": [1, 2, 3, 4, 5, 6, 7],
    "baxter": list(range(1, 16)),
    "owi535": [0, 1, 2, 3],
}

# left/right keypoint index pairs for a horizontal flip (baxter)
FLIP_PAIRS = [[1, 2], [3, 4], [5, 6], [7, 8], [9, 10], [11, 12], [13, 14],
              [15, 16]]

# actuation limits [lo, hi] per joint
JOINT_BOUNDS = {
    "panda": np.array([
        [-2.9671, 2.9671], [-1.8326, 1.8326], [-2.9671, 2.9671],
        [-3.1416, 0.0873], [-2.9671, 2.9671], [-0.0873, 3.8223],
        [-2.9671, 2.9671], [0.0000, 0.0400],
    ], dtype=np.float32),
    "kuka": np.array([
        [-2.9671, 2.9671], [-2.0944, 2.0944], [-2.9671, 2.9671],
        [-2.0944, 2.0944], [-2.9671, 2.9671], [-2.0944, 2.0944],
        [-3.0543, 3.0543],
    ], dtype=np.float32),
    "baxter": np.array([
        [-1.5708, 1.5708], [-1.7017, 1.7017], [-1.7017, 1.7017],
        [-2.1470, 1.0470], [-2.1470, 1.0470], [-3.0542, 3.0542],
        [-3.0542, 3.0542], [-0.0500, 2.6180], [-0.0500, 2.6180],
        [-3.0590, 3.0590], [-3.0590, 3.0590], [-1.5708, 2.0940],
        [-1.5708, 2.0940], [-3.0590, 3.0590], [-3.0590, 3.0590],
    ], dtype=np.float32),
    "owi535": np.array([
        [-2.268928, 2.268928], [-1.570796, 1.047198],
        [-1.047198, 1.570796], [-0.785398, 0.785398],
    ], dtype=np.float32),
}

# global training seed
GLOBAL_SEED = 808

# initial joint configurations: 'zero' and the dataset 'mean'
INITIAL_JOINT_ANGLE = {
    "zero": {r: {j: 0.0 for j in JOINT_NAMES[r]} for r in JOINT_NAMES},
    "mean": {
        "panda": {
            "panda_joint1": 0.0, "panda_joint2": 0.0, "panda_joint3": 0.0,
            "panda_joint4": -1.52715, "panda_joint5": 0.0,
            "panda_joint6": 1.8675, "panda_joint7": 0.0,
            "panda_finger_joint1": 0.02,
        },
        "kuka": {j: 0.0 for j in JOINT_NAMES["kuka"]},
        "baxter": {
            "head_pan": 0.0,
            "right_s0": 0.0, "left_s0": 0.0,
            "right_s1": -0.55, "left_s1": -0.55,
            "right_e0": 0.0, "left_e0": 0.0,
            "right_e1": 1.284, "left_e1": 1.284,
            "right_w0": 0.0, "left_w0": 0.0,
            "right_w1": 0.261601836605, "left_w1": 0.261601836605,
            "right_w2": 0.0, "left_w2": 0.0,
        },
        "owi535": {"Rotation": 0.0, "Base": -0.523598,
                   "Elbow": 0.523598, "Wrist": 0.0},
    },
}


def initial_joint_vector(kind: str, robot: str) -> np.ndarray:
    """Initial joint-angle vector ordered by JOINT_NAMES[robot]."""
    table = INITIAL_JOINT_ANGLE[kind][robot]
    return np.array([table[j] for j in JOINT_NAMES[robot]], dtype=np.float32)
