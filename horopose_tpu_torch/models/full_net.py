"""FullNet (RootNetwithRegInt): the flagship holistic pose model, NCHW.

Port of `horopose_tpu/models/full_net.py` for the flagship flags. Two
backbones: a rootnet backbone (hrnet32 by default) for the absolute root
depth, and a regression backbone (resnet50 by default) whose feature map
feeds (a) a 3-D heatmap head decoded by the soft-argmax and (b) a pooled
feature that drives weight-shared iterative MLP heads for the joint angles
and the 6-D root rotation. The root translation comes from (root uv,
depth, K^-1). Module names are the reference checkpoints' keys, so
`tools/jax_weights.py` maps the JAX variables onto `state_dict()` one to one.

dtype bfloat16 runs the conv stacks under autocast; `depth_layer`, the
decoding and the MLP heads stay float32, as the JAX model's Dense layers do.

Train mode (`model.train()`): BatchNorm normalises with the batch
statistics and updates its running statistics in place (momentum 0.1, the
unbiased variance, as the JAX package's BatchNorm), and the heads' dropout
draws its masks from the `torch.Generator` the caller passes, never from
the global generator, as the JAX step takes its dropout key.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from horopose_tpu_torch.models.hrnet import get_hrnet
from horopose_tpu_torch.models.resnet import batch_norm, get_resnet
from horopose_tpu_torch.ops.integral import (heatmap_integral_pose,
                                             integral_uvd)
from horopose_tpu_torch.ops.transforms import uvz_to_xyz_singlepoint

_RESNETS = ("resnet", "resnet18", "resnet34", "resnet50", "resnet101")
# "hrnet"/"hrnet32" -> w32; "hrnet48" -> w48
_HRNETS = ("hrnet", "hrnet32", "hrnet48")

_UNPORTED = ("not ported yet (ROADMAP queue 1 item 5: the non-flagship "
             "FullNet flags)")


def _hrnet_width(name: str) -> int:
    return 48 if str(name).endswith("48") else 32


class FullNet(nn.Module):
    def __init__(self, num_keypoints: int = 7, dof: int = 8,
                 backbone_name: str = "resnet50",
                 rootnet_backbone_name: str = "hrnet32",
                 image_size: int = 256, depth_dim: int = 64,
                 bbox_3d_shape: Tuple[float, float, float] = (1300.0, 1300.0,
                                                               1300.0),
                 reference_keypoint_id: int = 3, fix_root: bool = True,
                 n_iter: int = 4, p_dropout: float = 0.5,
                 rotation_dim: int = 6, direct_reg_rot: bool = False,
                 rot_iterative_matmul: bool = False,
                 reg_joint_map: bool = False, add_fc: bool = False,
                 multi_kp: bool = False,
                 init_pose: Sequence[float] = (),
                 init_rot: Sequence[float] = (1, 0, 0, 0, 1, 0),
                 use_kernel: Optional[bool] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for flag, on in (("multi_kp", multi_kp), ("add_fc", add_fc),
                         ("reg_joint_map", reg_joint_map),
                         ("direct_reg_rot", direct_reg_rot),
                         ("rot_iterative_matmul", rot_iterative_matmul)):
            if on:
                raise NotImplementedError(f"FullNet {flag}=True is {_UNPORTED}")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"FullNet dtype float32 or bfloat16, not {dtype}")
        self.num_keypoints = num_keypoints
        self.dof = dof
        self.image_size = int(image_size)
        self.depth_dim = depth_dim
        self.bbox_3d_shape = tuple(bbox_3d_shape)
        self.reference_keypoint_id = reference_keypoint_id
        self.fix_root = fix_root
        self.n_iter = n_iter
        self.rotation_dim = rotation_dim
        # None: the CUDA kernel on a CUDA tensor, the plain version on CPU;
        # False: the plain version (tests and chip_smoke.py compare with it)
        self.use_kernel = use_kernel
        self.dtype = dtype
        if len(init_pose) != dof:
            raise ValueError(f"init_pose needs {dof} values, got "
                             f"{len(init_pose)}")
        self.register_buffer("init_pose", torch.tensor(
            init_pose, dtype=torch.float32), persistent=False)
        self.register_buffer("init_rot", torch.tensor(
            init_rot, dtype=torch.float32), persistent=False)

        # ---- root depth branch ----
        if rootnet_backbone_name in _RESNETS:
            self.rootnet_backbone = get_resnet(rootnet_backbone_name)
            root_feat = self.rootnet_backbone.feature_channels
        elif rootnet_backbone_name in _HRNETS:
            self.rootnet_backbone = get_hrnet(
                _hrnet_width(rootnet_backbone_name), num_keypoints, depth_dim,
                generate_hm=False, generate_feat=True)
            root_feat = 2048
        else:
            raise NotImplementedError(rootnet_backbone_name)
        self.rootnet_is_resnet = rootnet_backbone_name in _RESNETS
        self.depth_layer = nn.Conv2d(root_feat, 1, 1)

        # ---- keypoint (integral) branch ----
        if backbone_name in _RESNETS:
            self.reg_backbone = get_resnet(backbone_name)
            reg_feat = self.reg_backbone.feature_channels
            layers, cin = [], reg_feat
            for _ in range(3):
                layers += [nn.ConvTranspose2d(cin, 256, 4, 2, 1, bias=False),
                           batch_norm(256), nn.ReLU(inplace=True)]
                cin = 256
            self.deconv_layers = nn.Sequential(*layers)
            self.final_layer = nn.Conv2d(256, num_keypoints * depth_dim, 1)
        elif backbone_name in _HRNETS:
            self.reg_backbone = get_hrnet(
                _hrnet_width(backbone_name), num_keypoints, depth_dim,
                generate_hm=True, generate_feat=True)
            reg_feat = 2048
        else:
            raise NotImplementedError(backbone_name)
        self.reg_is_resnet = backbone_name in _RESNETS

        # ---- iterative heads (weights shared across the n_iter steps) ----
        self.fc_pose_1 = nn.Linear(reg_feat + dof, 1024)
        self.fc_pose_2 = nn.Linear(1024, 1024)
        self.decpose = nn.Linear(1024, dof)
        self.fc_rot_1 = nn.Linear(reg_feat + rotation_dim, 1024)
        self.fc_rot_2 = nn.Linear(1024, 1024)
        self.decrot = nn.Linear(1024, rotation_dim)
        self.p_dropout = float(p_dropout)

    def _autocast(self, x: torch.Tensor):
        return torch.autocast(x.device.type, dtype=torch.bfloat16,
                              enabled=self.dtype == torch.bfloat16)

    def _root_feature(self, x_root):
        """The rootnet backbone's pooled feature (B, C)."""
        if self.rootnet_is_resnet:
            return self.rootnet_backbone(x_root).mean(dim=(2, 3))
        return self.rootnet_backbone(x_root)

    def _reg_features(self, x_reg):
        """The reg backbone -> (heatmap logits (B, K*D, H/4, W/4), pooled
        feature (B, C))."""
        if self.reg_is_resnet:
            x_out = self.reg_backbone(x_reg)
            return self.final_layer(self.deconv_layers(x_out)), \
                x_out.mean(dim=(2, 3))
        return self.reg_backbone(x_reg)

    def _depth(self, img_feat, k_value):
        """Root depth (B, 1) in metres from the root feature and k."""
        gamma = self.depth_layer(img_feat.float()[:, :, None, None])[:, :, 0, 0]
        return gamma * k_value.reshape(-1, 1).float() / 1000.0

    def root_depth(self, x_root, k_value):
        """The root-depth branch alone: rootnet backbone -> pooling ->
        depth_layer -> (B, 1) metres, as in forward."""
        with self._autocast(x_root):
            img_feat = self._root_feature(x_root)
        return self._depth(img_feat, k_value)

    def keypoint_uvd(self, x_reg):
        """The keypoint branch alone: reg backbone -> deconvs ->
        final_layer -> the 3-D soft-argmax -> uvd (B, K, 3), as in forward
        before the root fix and the lift to xyz."""
        with self._autocast(x_reg):
            hm, _ = self._reg_features(x_reg)
        n = self.image_size // 4
        return integral_uvd(hm, num_joints=self.num_keypoints,
                            depth_dim=self.depth_dim, height_dim=n,
                            width_dim=n, use_kernel=self.use_kernel)

    def _drop(self, x: torch.Tensor,
              generator: Optional[torch.Generator]) -> torch.Tensor:
        """Inverted dropout in train mode: keep where U[0, 1) >= p, scale
        by 1 / (1 - p); the identity in eval mode."""
        p = self.p_dropout
        if not self.training or p == 0.0:
            return x
        if generator is None:
            raise ValueError("FullNet in train mode with dropout needs the "
                             "step's torch.Generator (forward(..., "
                             "generator=g))")
        keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
        return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))

    def forward(self, x_reg, x_root, k_value, K,
                generator: Optional[torch.Generator] = None):
        """x_reg, x_root: (B, 3, S, S) float crops in [0, 1]; k_value (B,);
        K (B, 3, 3) intrinsics of the reg crop; generator: the dropout masks'
        source, needed in train mode when p_dropout > 0.

        Returns a dict: pose (B, dof), rot (B, rotation_dim), trans (B, 3),
        root_uv (B, 2) pixels, depth (B, 1) metres, uvd (B, K, 3),
        xyz_int (B, K, 3).
        """
        B = x_reg.shape[0]
        with self._autocast(x_reg):
            img_feat = self._root_feature(x_root)
            hm, xf = self._reg_features(x_reg)
        xf = xf.float()

        # ---- root depth ----
        pred_depth = self._depth(img_feat, k_value)
        root_trans = torch.cat([pred_depth.new_zeros(B, 2), pred_depth], -1)

        # ---- keypoints: (B, K*D, H, W) has channel order k*D + d, so it
        # reshapes straight to (B*K, D, H, W) ----
        heatmap_size = self.image_size // 4
        pred_uvd, pred_xyz_int = heatmap_integral_pose(
            hm, num_joints=self.num_keypoints, depth_dim=self.depth_dim,
            height_dim=heatmap_size, width_dim=heatmap_size,
            image_size=float(self.image_size),
            bbox_3d_shape=self.bbox_3d_shape, K=K, root_trans=root_trans,
            rootid=self.reference_keypoint_id, fixroot=self.fix_root,
            use_kernel=self.use_kernel)
        pred_root_uv = (pred_uvd[:, self.reference_keypoint_id, :2] + 0.5) \
            * self.image_size
        pred_trans = uvz_to_xyz_singlepoint(pred_root_uv, pred_depth,
                                            K.float())

        # ---- joint angles and rotation ----
        pred_pose = self.init_pose.expand(B, self.dof)
        for _ in range(self.n_iter):
            xc = torch.cat([xf, pred_pose], dim=1)
            xc = self._drop(self.fc_pose_1(xc), generator)
            xc = self._drop(self.fc_pose_2(xc), generator)
            pred_pose = self.decpose(xc) + pred_pose
        pred_rot = self.init_rot.expand(B, self.rotation_dim)
        for _ in range(self.n_iter):
            xc = torch.cat([xf, pred_rot], dim=1)
            xc = self._drop(self.fc_rot_1(xc), generator)
            xc = self._drop(self.fc_rot_2(xc), generator)
            pred_rot = self.decrot(xc) + pred_rot

        return dict(pose=pred_pose, rot=pred_rot, trans=pred_trans,
                    root_uv=pred_root_uv, depth=pred_depth, uvd=pred_uvd,
                    xyz_int=pred_xyz_int)
