"""Robot facade: keypoints from FK and root reframing.

Port of `horopose_tpu/kinematics/robot.py` for the serving and training
paths: keypoint links and offsets (with the Baxter joint-origin keypoints),
`get_keypoints_only_fk` (the base-frame keypoints the synthetic DREAM
writer annotates), `get_keypoints_root`, the FK lift that places
keypoint-link `root` in the camera, and `get_rotation_at_specific_root`,
which the ground truth of a non-base reference keypoint needs. All methods accept arbitrary leading
batch dims.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from horopose_tpu_torch import constants as C
from horopose_tpu_torch.kinematics.fk import KinematicPlan
from horopose_tpu_torch.kinematics.urdf import parse_urdf
from horopose_tpu_torch.ops.rotations import (invert_T, make_T, rot_to_rotmat,
                                              rotmat_to_rot)

_DESCRIPTIONS = os.path.join(os.path.dirname(__file__), "descriptions")

BUILTIN_URDF = {
    "panda": os.path.join(_DESCRIPTIONS, "panda.urdf"),
    "kuka": os.path.join(_DESCRIPTIONS, "kuka_iiwa7.urdf"),
    "baxter": os.path.join(_DESCRIPTIONS, "baxter.urdf"),
}


class Robot:
    """Per-robot kinematics: "panda" | "kuka" | "baxter" from the built-in
    descriptions, or any of them from an explicit `urdf_path`."""

    def __init__(self, robot_type: str, urdf_path: Optional[str] = None,
                 device="cuda"):
        if robot_type not in BUILTIN_URDF:
            raise ValueError(f"unknown robot type {robot_type!r}; supported: "
                             f"{sorted(BUILTIN_URDF)}")
        self.robot_type = robot_type
        self.device = torch.device(device)
        self.urdf_path = urdf_path or BUILTIN_URDF[robot_type]
        self.model = parse_urdf(self.urdf_path)
        self.dof = C.DOF[robot_type]
        missing = set(C.JOINT_NAMES[robot_type]) - set(self.model.joints)
        if missing:
            raise ValueError(f"URDF at {self.urdf_path} is missing actuated "
                             f"joints: {sorted(missing)}")
        self.plan = KinematicPlan(self.model, C.JOINT_NAMES[robot_type],
                                  device=self.device)
        self.link_names, offsets = self._keypoint_links_and_offsets()
        self._kp_offsets = torch.as_tensor(offsets, device=self.device)
        self._kp_link_idx = torch.as_tensor(
            [self.plan.link_names.index(n) for n in self.link_names],
            device=self.device)

    def _keypoint_links_and_offsets(self):
        if self.robot_type == "baxter":
            # Baxter keypoints live at joint origins, expressed as offsets in
            # the joint's PARENT link frame
            links, offs = [], []
            for jname in C.BAXTER_KEYPOINT_JOINTS:
                joint = self.model.joints[jname]
                links.append(joint.parent)
                offs.append(joint.origin[:3, 3].astype(np.float32))
            return links, np.stack(offs)
        links = C.LINK_NAMES[self.robot_type]
        return links, np.zeros((len(links), 3), np.float32)

    @property
    def num_keypoints(self) -> int:
        return len(self.link_names)

    def get_TWL(self, cfg: torch.Tensor) -> torch.Tensor:
        """Link poses at the keypoint links. cfg (..., DoF) -> (..., K, 4, 4)."""
        return self.plan.link_poses(cfg)[..., self._kp_link_idx, :, :]

    def _keypoints_from_TWL(self, TWL: torch.Tensor) -> torch.Tensor:
        """(..., K, 4, 4) -> keypoint positions (..., K, 3) with offsets."""
        R = TWL[..., :3, :3]
        t = TWL[..., :3, 3]
        return torch.einsum("...kij,kj->...ki", R, self._kp_offsets) + t

    def get_keypoints_only_fk(self, cfg: torch.Tensor) -> torch.Tensor:
        """Keypoints in the robot base frame (identity world pose)."""
        return self._keypoints_from_TWL(self.get_TWL(cfg))

    def get_keypoints(self, cfg: torch.Tensor, rot: torch.Tensor,
                      trans: torch.Tensor) -> torch.Tensor:
        """Camera-frame keypoints given base-to-camera (rot, trans)."""
        base2cam = make_T(rot_to_rotmat(rot), trans)[..., None, :, :]
        return self._keypoints_from_TWL(base2cam @ self.get_TWL(cfg))

    def get_keypoints_root(self, cfg: torch.Tensor, rot: torch.Tensor,
                           trans: torch.Tensor, root: int = 0) -> torch.Tensor:
        """Camera-frame keypoints when (rot, trans) places keypoint-link
        `root` (not the base) in the camera."""
        if root == 0:
            return self.get_keypoints(cfg, rot, trans)
        if not 0 < root < self.num_keypoints:
            raise ValueError(f"root {root} out of range for "
                             f"{self.num_keypoints} keypoints")
        base2cam = make_T(rot_to_rotmat(rot), trans)[..., None, :, :]
        TWL = self.get_TWL(cfg)
        root_inv = invert_T(TWL[..., root:root + 1, :, :])
        return self._keypoints_from_TWL(base2cam @ (root_inv @ TWL))

    def get_rotation_at_specific_root(self, cfg: torch.Tensor,
                                      rot: torch.Tensor, trans: torch.Tensor,
                                      root: int = 0) -> torch.Tensor:
        """Rotation (same representation as `rot`) of keypoint-link `root`
        in the camera frame, given base-to-camera (rot, trans)."""
        if root == 0:
            return rot
        base2cam = make_T(rot_to_rotmat(rot), trans)[..., None, :, :]
        TWL = base2cam @ self.get_TWL(cfg)
        return rotmat_to_rot(TWL[..., root, :3, :3], rot.shape[-1])
