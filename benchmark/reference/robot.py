"""Forward kinematics and keypoints of a robot, in plain PyTorch.

Reads the robot's URDF (a copy beside this file) and its keypoint table
(`robots/<robot>.json`: the actuated joints in the order of the joint
vector, the keypoints as links or as joint origins, the dataset's mean
joint angles). A keypoint is the origin of a link, or (baxter) the origin
of a joint, expressed in its parent link. FK walks the tree from the root
link: each joint's pose is its parent link's pose, times its fixed origin,
times its motion (a rotation about its axis, or a slide along it).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple
from xml.etree import ElementTree

import numpy as np
import torch

ROBOTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "robots")


def _rpy(rpy) -> np.ndarray:
    """URDF roll-pitch-yaw -> Rz(y) Ry(p) Rx(r)."""
    r, p, y = rpy
    cr, sr, cp, sp, cy, sy = (np.cos(r), np.sin(r), np.cos(p), np.sin(p),
                              np.cos(y), np.sin(y))
    return np.array([[cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
                     [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
                     [-sp, cp * sr, cp * cr]])


def _origin(node) -> np.ndarray:
    T = np.eye(4)
    origin = node.find("origin")
    if origin is not None:
        T[:3, :3] = _rpy([float(v) for v in origin.get("rpy", "0 0 0").split()])
        T[:3, 3] = [float(v) for v in origin.get("xyz", "0 0 0").split()]
    return T


def read_joints(urdf_path: str) -> Tuple[str, List[dict]]:
    """(root link, joints in tree order from the root), each joint a dict
    of name, type, parent, child, origin (4x4), unit axis and mimic."""
    root = ElementTree.parse(urdf_path).getroot()
    joints = []
    for node in root.findall("joint"):
        axis_node = node.find("axis")
        axis = np.array([1.0, 0.0, 0.0] if axis_node is None else
                        [float(v) for v in axis_node.get("xyz").split()])
        mimic = node.find("mimic")
        joints.append(dict(
            name=node.get("name"), type=node.get("type"),
            parent=node.find("parent").get("link"),
            child=node.find("child").get("link"), origin=_origin(node),
            axis=axis / np.linalg.norm(axis),
            mimic=None if mimic is None else (
                mimic.get("joint"), float(mimic.get("multiplier", 1.0)),
                float(mimic.get("offset", 0.0)))))
    links = [n.get("name") for n in root.findall("link")]
    children = {j["child"] for j in joints}
    base = [name for name in links if name not in children][0]
    ordered, frontier = [], [base]
    while frontier:
        link = frontier.pop(0)
        for j in joints:
            if j["parent"] == link:
                ordered.append(j)
                frontier.append(j["child"])
    return base, ordered


class RobotFK:
    """Keypoints of one robot from its joint vector, batched."""

    def __init__(self, name: str, device="cpu", dtype=torch.float32):
        with open(os.path.join(ROBOTS, f"{name}.json")) as f:
            table = json.load(f)
        self.name = name
        self.device, self.dtype = torch.device(device), dtype
        self.joint_names: List[str] = table["joint_names"]
        self.dof = len(self.joint_names)
        self.mean_joints = np.asarray(table["mean_joints"], np.float64)
        self.base, self.joints = read_joints(
            os.path.join(ROBOTS, f"{name}.urdf"))
        by_name = {j["name"]: j for j in self.joints}
        if "keypoint_links" in table:
            self.kp_links = list(table["keypoint_links"])
            offsets = np.zeros((len(self.kp_links), 3))
        else:
            origins = [by_name[n] for n in table["keypoint_joint_origins"]]
            self.kp_links = [j["parent"] for j in origins]
            offsets = np.stack([j["origin"][:3, 3] for j in origins])
        self.kp_offsets = self._t(offsets)
        self.num_keypoints = len(self.kp_links)

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    def _angle(self, joint: dict, q: torch.Tensor) -> torch.Tensor:
        """The joint's position (B,): its entry of q, a mimic's affine map
        of its source's, or 0 for an actuated joint outside the vector."""
        if joint["mimic"] is not None:
            src, mult, off = joint["mimic"]
            if src in self.joint_names:
                return q[:, self.joint_names.index(src)] * mult + off
            return q.new_zeros(q.shape[0])
        if joint["name"] in self.joint_names:
            return q[:, self.joint_names.index(joint["name"])]
        return q.new_zeros(q.shape[0])

    def _motion(self, joint: dict, q: torch.Tensor) -> torch.Tensor:
        B = q.shape[0]
        T = torch.eye(4, dtype=self.dtype, device=self.device).repeat(B, 1, 1)
        if joint["type"] in ("revolute", "continuous"):
            a = self._angle(joint, q)
            x, y, z = (float(v) for v in joint["axis"])
            c, s = torch.cos(a), torch.sin(a)
            C = 1.0 - c
            T[:, :3, :3] = torch.stack([
                torch.stack([c + x * x * C, x * y * C - z * s,
                             x * z * C + y * s], -1),
                torch.stack([y * x * C + z * s, c + y * y * C,
                             y * z * C - x * s], -1),
                torch.stack([z * x * C - y * s, z * y * C + x * s,
                             c + z * z * C], -1)], -2)
        elif joint["type"] == "prismatic":
            T[:, :3, 3] = self._angle(joint, q)[:, None] * \
                self._t(joint["axis"])[None]
        return T

    def link_poses(self, q: torch.Tensor) -> Dict[str, torch.Tensor]:
        """q (B, dof) -> {link: (B, 4, 4) pose in the base frame}."""
        q = q.to(self.dtype)
        B = q.shape[0]
        poses = {self.base: torch.eye(4, dtype=self.dtype,
                                      device=self.device).repeat(B, 1, 1)}
        for j in self.joints:
            poses[j["child"]] = poses[j["parent"]] @ \
                self._t(j["origin"])[None] @ self._motion(j, q)
        return poses

    def keypoint_frames(self, q: torch.Tensor) -> torch.Tensor:
        """(B, K, 4, 4): the pose of each keypoint's link."""
        poses = self.link_poses(q)
        return torch.stack([poses[n] for n in self.kp_links], 1)

    @staticmethod
    def points(frames: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
        """Keypoints (..., K, 3) of frames (..., K, 4, 4) and link offsets."""
        return (frames[..., :3, :3] @ offsets[..., None])[..., 0] + \
            frames[..., :3, 3]

    def keypoints_base(self, q: torch.Tensor) -> torch.Tensor:
        """Keypoints (B, K, 3) in the robot's base frame."""
        return self.points(self.keypoint_frames(q), self.kp_offsets)

    def keypoints_camera(self, q, R, t, root: int = 0) -> torch.Tensor:
        """Camera-frame keypoints (B, K, 3) where (R (B, 3, 3), t (B, 3))
        places keypoint-link `root`'s frame in the camera."""
        frames = self.keypoint_frames(q)
        if root:
            R0 = frames[:, root:root + 1, :3, :3].transpose(-1, -2)
            inv = torch.zeros_like(frames[:, root:root + 1])
            inv[..., :3, :3] = R0
            inv[..., :3, 3] = -(R0 @ frames[:, root:root + 1, :3, 3:])[..., 0]
            inv[..., 3, 3] = 1.0
            frames = inv @ frames
        cam = torch.eye(4, dtype=self.dtype, device=self.device).repeat(
            q.shape[0], 1, 1)
        cam[:, :3, :3], cam[:, :3, 3] = R.to(self.dtype), t.to(self.dtype)
        return self.points(cam[:, None] @ frames, self.kp_offsets)

    def root_rotation(self, q, R, root: int) -> torch.Tensor:
        """Rotation (B, 3, 3) of keypoint-link `root` in the camera, given
        the base's rotation R."""
        return R.to(self.dtype) @ self.keypoint_frames(q)[:, root, :3, :3]
