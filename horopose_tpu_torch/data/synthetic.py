"""A synthetic training batch in the DREAM layout, made from a numpy seed.

The batch has the keys and shapes the JAX package's `DreamDataset` and
`DataLoader` give (`horopose_tpu/data/dream.py`): the robot's joints and
base-to-camera pose, its keypoints from the port's own FK, projected into a
640x480 frame and into square crops around them, with the crop intrinsics,
bboxes and visibility masks. The crops are random uint8 pixels: the batch
exercises the training step's arithmetic, not learning. It lets a train
step run where no dataset is on disk (chip_smoke.py, the README's CPU
recipe).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from horopose_tpu_torch.constants import initial_joint_vector
from horopose_tpu_torch.core.engine import batch_to_torch
from horopose_tpu_torch.kinematics.robot import Robot
from horopose_tpu_torch.ops.rotations import rotmat_to_rot6d
from horopose_tpu_torch.ops.transforms import project_points

FRAME_WH = (640, 480)
# RealSense-like intrinsics of the 640x480 frames
K_FRAME = ((615.52, 0.0, 328.26), (0.0, 615.22, 251.79), (0.0, 0.0, 1.0))
# the extended-bbox margins, as fractions of the keypoint box (extend_ratio)
EXTEND_RATIO = (0.2, 0.13)


def _rotations(rng: np.random.RandomState, n: int) -> np.ndarray:
    q, r = np.linalg.qr(rng.randn(n, 3, 3))
    q = q * np.sign(np.diagonal(r, axis1=-2, axis2=-1))[:, None, :]
    q[np.linalg.det(q) < 0, :, 0] *= -1
    return q


def _box(kp2d: np.ndarray) -> np.ndarray:
    return np.concatenate([kp2d.min(axis=1), kp2d.max(axis=1)], -1)


def _inside(kp2d: np.ndarray, w: float, h: float) -> np.ndarray:
    return ((kp2d[..., 0] >= 0) & (kp2d[..., 0] < w) & (kp2d[..., 1] >= 0)
            & (kp2d[..., 1] < h)).astype(np.float32)


def _crop(rng, kp3d, K, center, side, size: int) -> Dict[str, np.ndarray]:
    """One square crop of `side` frame pixels around `center`, resized to
    `size`: its intrinsics, keypoints, masks and bboxes."""
    B = kp3d.shape[0]
    scale = size / side
    K_crop = np.tile(K[None], (B, 1, 1))
    K_crop[:, 0, 2] -= center[:, 0] - side / 2
    K_crop[:, 1, 2] -= center[:, 1] - side / 2
    K_crop[:, :2] *= scale[:, None, None]
    kp2d = (project_points(torch.from_numpy(K_crop), torch.from_numpy(kp3d))
            .numpy())
    box = _box(kp2d)
    wh = box[:, 2:] - box[:, :2]
    margin = np.concatenate([wh * EXTEND_RATIO] * 2, -1) * [-1, -1, 1, 1]
    return dict(
        images=rng.randint(0, 256, (B, size, size, 3), dtype=np.uint8),
        K=K_crop, keypoints_3d=kp3d, keypoints_2d=kp2d,
        valid_mask_crop=_inside(kp2d, size, size),
        bbox_strict_bounded=np.clip(box, 0, size),
        bbox_gt2d_extended=np.clip(box + margin, 0, size))


def synthetic_dream_batch(robot: Robot, batch_size: int, image_size: int,
                          rootnet_image_size: int, seed: int,
                          device="cuda") -> Dict:
    """A DREAM-layout batch of `batch_size` rows on `device`: random joints
    around the dataset mean, a random base rotation, the base 1-2 m in front
    of the camera; float32 tensors and uint8 (B, S, S, 3) crops."""
    rng = np.random.RandomState(seed)
    B, dof = batch_size, robot.dof
    joints = (initial_joint_vector("mean", robot.robot_type)[None]
              + rng.uniform(-0.4, 0.4, (B, dof))).astype(np.float64)
    R = _rotations(rng, B)
    t = np.stack([rng.uniform(-0.15, 0.15, B), rng.uniform(-0.15, 0.15, B),
                  rng.uniform(1.0, 2.0, B)], -1)
    TCO = np.tile(np.eye(4)[None], (B, 1, 1))
    TCO[:, :3, :3], TCO[:, :3, 3] = R, t
    f32 = dict(dtype=torch.float32, device=robot.device)
    kp3d = robot.get_keypoints(
        torch.as_tensor(joints, **f32),
        rotmat_to_rot6d(torch.as_tensor(R, **f32)),
        torch.as_tensor(t, **f32)).double().cpu().numpy()
    K = np.asarray(K_FRAME)
    kp2d = project_points(torch.from_numpy(np.tile(K[None], (B, 1, 1))),
                          torch.from_numpy(kp3d)).numpy()
    box = _box(kp2d)
    center = (box[:, :2] + box[:, 2:]) / 2
    side = (box[:, 2:] - box[:, :2]).max(axis=1) + 40.0    # 20 px margins
    w, h = FRAME_WH
    frame_box = np.clip(box, 0, [w, h, w, h])
    batch = dict(
        TCO=TCO, K_original=np.tile(K[None], (B, 1, 1)), jointpose=joints,
        keypoints_2d_original=kp2d, keypoints_3d_original=kp3d,
        valid_mask=_inside(kp2d, w, h),
        bbox_strict_bounded_original=frame_box,
        root=_crop(rng, kp3d, K, center, side, rootnet_image_size),
        other=_crop(rng, kp3d, K, center, side, image_size))

    def f32(tree):
        return {k: f32(v) if isinstance(v, dict)
                else v if v.dtype == np.uint8 else v.astype(np.float32)
                for k, v in tree.items()}

    return batch_to_torch(f32(batch), device)
