"""The flagship FullNet in plain PyTorch: a frozen copy of its equations.

Two backbones: hrnet32's 2048-d feature gives the root depth (a 1x1 conv
`depth_layer` scaled by the k prior), resnet50's feature map gives (a)
three stride-2 deconvolutions and a 1x1 conv to K x D heatmap channels,
decoded by a 3-D soft-argmax into uvd and lifted into the camera with the
crop intrinsics and the root depth, and (b) its pooled feature, from which
two weight-shared MLPs (fc 1024, dropout, fc 1024, dropout, out) iterate
n_iter times from the mean joints and the identity rotation (6-D). The
soft-argmax here is the softmax written out, with no kernel.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
from torch import nn

from benchmark.reference.nets import HRNet32Feature, ResNet50, bn
from benchmark.reference.robot import RobotFK


def soft_argmax_3d(x: torch.Tensor) -> torch.Tensor:
    """x (N, D, H, W) logits -> uvd (N, 3) in [-0.5, 0.5], ordered (w, h,
    d): the expectation of each index under the softmax, over its size."""
    N, D, H, W = x.shape
    p = torch.softmax(x.reshape(N, -1).float(), dim=-1).reshape(N, D, H, W)
    f = dict(dtype=p.dtype, device=p.device)
    e_w = p.sum(dim=(1, 2)) @ torch.arange(W, **f)
    e_h = p.sum(dim=(1, 3)) @ torch.arange(H, **f)
    e_d = p.sum(dim=(2, 3)) @ torch.arange(D, **f)
    return torch.stack([e_w / W, e_h / H, e_d / D], -1) - 0.5


def inv_K(K: torch.Tensor) -> torch.Tensor:
    """Inverse of pinhole intrinsics (..., 3, 3) without skew."""
    fx, fy, cx, cy = K[..., 0, 0], K[..., 1, 1], K[..., 0, 2], K[..., 1, 2]
    out = torch.zeros_like(K)
    out[..., 0, 0], out[..., 1, 1] = 1.0 / fx, 1.0 / fy
    out[..., 0, 2], out[..., 1, 2] = -cx / fx, -cy / fy
    out[..., 2, 2] = 1.0
    return out


def project(K: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Pinhole projection of (B, N, 3) camera points with K (B, 3, 3)."""
    p = points @ K.transpose(-1, -2)
    z = p[..., 2:3]
    z = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    return p[..., :2] / z


def rot6d_to_rotmat(r6: torch.Tensor) -> torch.Tensor:
    """6-D (the first two rows) -> rotation matrix by Gram-Schmidt."""
    x = r6[..., :3] / torch.linalg.norm(r6[..., :3], dim=-1, keepdim=True)
    z = torch.linalg.cross(x, r6[..., 3:], dim=-1)
    z = z / torch.linalg.norm(z, dim=-1, keepdim=True)
    return torch.stack([x, torch.linalg.cross(z, x, dim=-1), z], -2)


class FullNet(nn.Module):
    def __init__(self, num_keypoints: int, dof: int, mean_joints,
                 image_size: int = 256, depth_dim: int = 64,
                 bbox_3d_depth: float = 1300.0, reference_keypoint_id: int = 3,
                 n_iter: int = 4, p_dropout: float = 0.5):
        super().__init__()
        self.K, self.dof, self.D = num_keypoints, dof, depth_dim
        self.image_size, self.n_iter, self.p = image_size, n_iter, p_dropout
        self.ref = reference_keypoint_id
        self.depth_factor = bbox_3d_depth * 1e-3
        self.mean_joints = tuple(float(v) for v in mean_joints)
        self.rootnet_backbone = HRNet32Feature()
        self.depth_layer = nn.Conv2d(2048, 1, 1)
        self.reg_backbone = ResNet50()
        layers, cin = [], 2048
        for _ in range(3):
            layers += [nn.ConvTranspose2d(cin, 256, 4, 2, 1, bias=False),
                       bn(256), nn.ReLU()]
            cin = 256
        self.deconv_layers = nn.Sequential(*layers)
        self.final_layer = nn.Conv2d(256, num_keypoints * depth_dim, 1)
        self.fc_pose_1 = nn.Linear(2048 + dof, 1024)
        self.fc_pose_2 = nn.Linear(1024, 1024)
        self.decpose = nn.Linear(1024, dof)
        self.fc_rot_1 = nn.Linear(2048 + 6, 1024)
        self.fc_rot_2 = nn.Linear(1024, 1024)
        self.decrot = nn.Linear(1024, 6)

    def _drop(self, x, generator: Optional[torch.Generator]):
        """Inverted dropout in train mode: kept where U[0, 1) >= p."""
        if not self.training or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=generator, device=x.device) \
            >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))

    def _iterate(self, xf, init, fc1, fc2, out, generator):
        init = torch.tensor(init, dtype=xf.dtype, device=xf.device)
        pred = init.expand(xf.shape[0], init.shape[0])
        for _ in range(self.n_iter):
            h = self._drop(fc1(torch.cat([xf, pred], 1)), generator)
            h = self._drop(fc2(h), generator)
            pred = out(h) + pred
        return pred

    def forward(self, x_reg, x_root, k_value, K,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """x_reg, x_root (B, 3, S, S) in [0, 1]; k_value (B,); K (B, 3, 3)
        of the regression crop. Returns pose, rot (6-D), trans, root_uv,
        depth, uvd and xyz_int, as the program's forward names them."""
        B = x_reg.shape[0]
        depth = self.depth_layer(self.rootnet_backbone(x_root)[:, :, None,
                                                               None])[:, :, 0, 0]
        depth = depth * k_value.reshape(-1, 1) / 1000.0
        fmap = self.reg_backbone(x_reg)
        hm = self.final_layer(self.deconv_layers(fmap))
        n = self.image_size // 4
        uvd = soft_argmax_3d(hm.reshape(B * self.K, self.D, n, n)).reshape(
            B, self.K, 3)
        root_d = torch.zeros(self.K, 3, dtype=torch.bool, device=uvd.device)
        root_d[self.ref, 2] = True
        uvd = uvd.masked_fill(root_d, 0.0)          # the root's depth is 0
        uv = (uvd[..., :2] + 0.5) * self.image_size
        rays = torch.cat([uv, torch.ones_like(uv[..., :1])], -1) @ \
            inv_K(K).transpose(-1, -2)
        xyz_int = rays * (uvd[..., 2] * self.depth_factor + depth)[..., None]
        root_uv = (uvd[:, self.ref, :2] + 0.5) * self.image_size
        trans = (torch.cat([root_uv * depth, depth], -1)[:, None]
                 @ inv_K(K).transpose(-1, -2))[:, 0]
        xf = fmap.mean(dim=(2, 3))
        pose = self._iterate(xf, self.mean_joints, self.fc_pose_1,
                             self.fc_pose_2, self.decpose, generator)
        rot = self._iterate(xf, (1.0, 0.0, 0.0, 0.0, 1.0, 0.0),
                            self.fc_rot_1, self.fc_rot_2, self.decrot,
                            generator)
        return dict(pose=pose, rot=rot, trans=trans, root_uv=root_uv,
                    depth=depth, uvd=uvd, xyz_int=xyz_int)


def reference_model(config: Mapping, robot: RobotFK, device="meta") -> FullNet:
    """The configuration's FullNet for `robot`, built on `device` (on the
    meta device by default: only its structure, for weights to fill)."""
    with torch.device(device):
        return FullNet(robot.num_keypoints, robot.dof, robot.mean_joints,
                       image_size=int(config["image_size"]),
                       depth_dim=int(config["depth_dim"]),
                       bbox_3d_depth=float(config["bbox_3d_shape"][2]),
                       reference_keypoint_id=int(
                           config["reference_keypoint_id"]),
                       n_iter=int(config["n_iter"]),
                       p_dropout=float(config["p_dropout"]))
