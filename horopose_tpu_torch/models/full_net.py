"""FullNet (RootNetwithRegInt): the holistic pose model, NCHW.

Port of `horopose_tpu/models/full_net.py`, every flag. Two backbones: a
rootnet backbone (hrnet32 by default) for the absolute root depth, and a
regression backbone (resnet50 by default) whose feature map feeds (a) a 3-D
heatmap head decoded by the soft-argmax and (b) a pooled feature that
drives weight-shared iterative MLP heads for the joint angles and the root
rotation. The root translation comes from (root uv, depth, K^-1). Module
names are the reference checkpoints' keys, so `tools/jax_weights.py` maps
the JAX variables onto `state_dict()` one to one.

The variants, as in the JAX model:
- `add_fc`: a bottleneck on the root feature (`depth_fc_d1` -> 1024,
  `depth_fc_d2` -> 512, `depth_bn` and leaky ReLU, `depth_fc_u2` -> 1024
  averaged with d1's output, `depth_fc_u1` back to the feature width
  averaged with the feature);
- `multi_kp`: `depth_layer` predicts the depth of every keypoint in
  `kps_need_depth` (returned as `depths`); the root depth is the column of
  `reference_keypoint_id`;
- `reg_joint_map`: joint angles from a 1-D soft-argmax over per-joint maps
  (3x3 convs with BatchNorm and ReLU, then a 1x1 conv to `dof`) on the
  resnet feature map, scaled to `joint_bounds`, in place of the pose MLP;
- `direct_reg_rot`: the rotation from six Dense layers with a skip from
  the first, applied once, in place of the iterative head;
- `rot_iterative_matmul`: each iteration composes the rotation matrices
  instead of adding 6-D vectors;
- `rotation_dim` 4: quaternion rotations (`init_rot` (1, 0, 0, 0)).

A fresh model draws its weights as the JAX model's initialisers do:
flax's defaults (`models/common.py::init_like_flax_`), `depth_layer` from
normal(0, 0.001), the resnet path's `final_layer` from normal(0,
sqrt(2 / (K * D))), `decpose` and `decrot` Glorot-uniform, biases 0.

`remat` recomputes each backbone unit's forward in the backward (both
backbones; `models/common.py::remat_call`), the JAX model's `remat`: the
state dict and the results are the same, the activation memory less.

dtype bfloat16 runs the conv stacks under autocast; `depth_layer`, the fc
bottleneck, the decoding and the MLP heads stay float32, as the JAX
model's Dense layers do.

Train mode (`model.train()`): BatchNorm normalises with the batch
statistics and updates its running statistics in place (momentum 0.1, the
unbiased variance, as the JAX package's BatchNorm), and the heads' dropout
draws its masks from the `torch.Generator` the caller passes, never from
the global generator, as the JAX step takes its dropout key.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from horopose_tpu_torch.models.common import init_like_flax_
from horopose_tpu_torch.models.hrnet import get_hrnet
from horopose_tpu_torch.models.resnet import batch_norm, get_resnet
from horopose_tpu_torch.ops.integral import (heatmap_integral_joint,
                                             heatmap_integral_pose,
                                             integral_uvd)
from horopose_tpu_torch.ops.rotations import rot6d_to_rotmat, rotmat_to_rot6d
from horopose_tpu_torch.ops.transforms import uvz_to_xyz_singlepoint

_RESNETS = ("resnet", "resnet18", "resnet34", "resnet50", "resnet101")
# "hrnet"/"hrnet32" -> w32; "hrnet48" -> w48
_HRNETS = ("hrnet", "hrnet32", "hrnet48")


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
                 reg_joint_map: bool = False,
                 joint_conv_dim: Sequence[int] = (256, 256, 256),
                 joint_bounds: Optional[Sequence[Sequence[float]]] = None,
                 add_fc: bool = False, multi_kp: bool = False,
                 kps_need_depth: Optional[Sequence[int]] = None,
                 init_pose: Sequence[float] = (),
                 init_rot: Sequence[float] = (1, 0, 0, 0, 1, 0),
                 use_kernel: Optional[bool] = None,
                 remat: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"FullNet dtype float32 or bfloat16, not {dtype}")
        if len(init_pose) != dof:
            raise ValueError(f"init_pose needs {dof} values, got "
                             f"{len(init_pose)}")
        if len(init_rot) != rotation_dim:
            # the JAX model fails here too: it broadcasts init_rot to
            # (B, rotation_dim), and its build_fullnet gives 6 values for
            # every rotation_dim but 4
            raise ValueError(f"init_rot needs rotation_dim={rotation_dim} "
                             f"values, got {len(init_rot)}")
        if rot_iterative_matmul and rotation_dim != 6:
            raise ValueError("rot_iterative_matmul composes 6-D rotations; "
                             f"rotation_dim is {rotation_dim}")
        self.num_keypoints = num_keypoints
        self.dof = dof
        self.image_size = int(image_size)
        self.depth_dim = depth_dim
        self.bbox_3d_shape = tuple(bbox_3d_shape)
        self.reference_keypoint_id = reference_keypoint_id
        self.fix_root = fix_root
        self.n_iter = n_iter
        self.rotation_dim = rotation_dim
        self.backbone_name = backbone_name
        self.rootnet_backbone_name = rootnet_backbone_name
        self.direct_reg_rot = direct_reg_rot
        self.rot_iterative_matmul = rot_iterative_matmul
        self.reg_joint_map = reg_joint_map
        self.add_fc = add_fc
        self.multi_kp = multi_kp
        # None: the CUDA kernel on a CUDA tensor, the plain version on CPU;
        # False: the plain version (tests and chip_smoke.py compare with it)
        self.use_kernel = use_kernel
        self.dtype = dtype
        self.register_buffer("init_pose", torch.tensor(
            init_pose, dtype=torch.float32), persistent=False)
        self.register_buffer("init_rot", torch.tensor(
            init_rot, dtype=torch.float32), persistent=False)

        # ---- root depth branch ----
        if rootnet_backbone_name in _RESNETS:
            self.rootnet_backbone = get_resnet(rootnet_backbone_name,
                                               remat=remat)
            root_feat = self.rootnet_backbone.feature_channels
        elif rootnet_backbone_name in _HRNETS:
            self.rootnet_backbone = get_hrnet(
                _hrnet_width(rootnet_backbone_name), num_keypoints, depth_dim,
                generate_hm=False, generate_feat=True, remat=remat)
            root_feat = 2048
        else:
            raise NotImplementedError(rootnet_backbone_name)
        self.rootnet_is_resnet = rootnet_backbone_name in _RESNETS
        if add_fc:
            self.depth_fc_d1 = nn.Linear(root_feat, 1024)
            self.depth_fc_d2 = nn.Linear(1024, 512)
            self.depth_bn = nn.BatchNorm1d(512, eps=1e-5, momentum=0.1)
            self.depth_fc_u2 = nn.Linear(512, 1024)
            self.depth_fc_u1 = nn.Linear(1024, root_feat)
        # the root depth is column `root_depth_index` of depth_layer's output
        if multi_kp:
            self.kps_need_depth = tuple(int(k) for k in kps_need_depth)
            self.root_depth_index = self.kps_need_depth.index(
                reference_keypoint_id)
        else:
            self.kps_need_depth = None
            self.root_depth_index = 0
        self.depth_layer = nn.Conv2d(
            root_feat, len(self.kps_need_depth) if multi_kp else 1, 1)

        # ---- keypoint (integral) branch ----
        if backbone_name in _RESNETS:
            self.reg_backbone = get_resnet(backbone_name, remat=remat)
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
                generate_hm=True, generate_feat=True, remat=remat)
            reg_feat = 2048
        else:
            raise NotImplementedError(backbone_name)
        self.reg_is_resnet = backbone_name in _RESNETS

        # ---- joint angles: per-joint maps, or the iterative MLP ----
        if reg_joint_map:
            if not self.reg_is_resnet:
                raise ValueError("reg_joint_map reads the resnet feature "
                                 f"map; the {backbone_name} backbone has "
                                 "none")
            if joint_bounds is None:
                raise ValueError("reg_joint_map needs joint_bounds (dof, 2)")
            layers, cin = [], reg_feat
            for ch in joint_conv_dim:
                layers += [nn.Conv2d(cin, ch, 3, padding=1), batch_norm(ch),
                           nn.ReLU(inplace=True)]
                cin = ch
            self.joint_conv_layers = nn.Sequential(*layers)
            self.joint_final_layer = nn.Conv2d(cin, dof, 1)
            self.register_buffer("joint_bounds", torch.tensor(
                joint_bounds, dtype=torch.float32).reshape(dof, 2),
                persistent=False)
        else:
            # weights shared across the n_iter steps
            self.fc_pose_1 = nn.Linear(reg_feat + dof, 1024)
            self.fc_pose_2 = nn.Linear(1024, 1024)
            self.decpose = nn.Linear(1024, dof)

        # ---- rotation: six Dense layers once, or the iterative MLP ----
        if direct_reg_rot:
            self.fc_rot_1 = nn.Linear(reg_feat, 1024)
            for i in range(2, 7):
                setattr(self, f"fc_rot_{i}", nn.Linear(1024, 1024))
        else:
            self.fc_rot_1 = nn.Linear(reg_feat + rotation_dim, 1024)
            self.fc_rot_2 = nn.Linear(1024, 1024)
        self.decrot = nn.Linear(1024, rotation_dim)
        self.p_dropout = float(p_dropout)

        # the JAX model's initialisers: flax's defaults, then its heads'
        init_like_flax_(self)
        nn.init.normal_(self.depth_layer.weight, std=0.001)
        if self.reg_is_resnet:
            nn.init.normal_(self.final_layer.weight,
                            std=(2.0 / (num_keypoints * depth_dim)) ** 0.5)
        nn.init.xavier_uniform_(self.decrot.weight)
        if not reg_joint_map:
            nn.init.xavier_uniform_(self.decpose.weight)

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
        feature (B, C), the resnet feature map or None for hrnet)."""
        if self.reg_is_resnet:
            x_out = self.reg_backbone(x_reg)
            return self.final_layer(self.deconv_layers(x_out)), \
                x_out.mean(dim=(2, 3)), x_out
        hm, xf = self.reg_backbone(x_reg)
        return hm, xf, None

    def _depths(self, img_feat, k_value):
        """Depths (B, 1), or (B, len(kps_need_depth)) with multi_kp, in
        metres from the root feature and k; the fc bottleneck first with
        add_fc."""
        f = img_feat.float()
        if self.add_fc:
            f1 = self.depth_fc_d1(f)
            mid = F.leaky_relu(self.depth_bn(self.depth_fc_d2(f1)))
            f3 = 0.5 * (self.depth_fc_u2(mid) + f1)
            f = 0.5 * (self.depth_fc_u1(f3) + f)
        gamma = self.depth_layer(f[:, :, None, None])[:, :, 0, 0]
        return gamma * k_value.reshape(-1, 1).float() / 1000.0

    def _root_depth(self, depths):
        i = self.root_depth_index
        return depths[:, i:i + 1]

    def root_depth(self, x_root, k_value):
        """The root-depth branch alone: rootnet backbone -> pooling ->
        (bottleneck) -> depth_layer -> (B, 1) metres, as in forward."""
        with self._autocast(x_root):
            img_feat = self._root_feature(x_root)
        return self._root_depth(self._depths(img_feat, k_value))

    def keypoint_uvd(self, x_reg):
        """The keypoint branch alone: reg backbone -> deconvs ->
        final_layer -> the 3-D soft-argmax -> uvd (B, K, 3), as in forward
        before the root fix and the lift to xyz."""
        with self._autocast(x_reg):
            hm = self._reg_features(x_reg)[0]
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

    def _pose(self, xf, x_out, generator):
        """Joint angles (B, dof): the per-joint maps' 1-D soft-argmax, or
        n_iter weight-shared residual MLP steps from init_pose."""
        if self.reg_joint_map:
            with self._autocast(x_out):
                jm = self.joint_final_layer(self.joint_conv_layers(x_out))
            return heatmap_integral_joint(jm, dof=self.dof,
                                          joint_bounds=self.joint_bounds)
        pred_pose = self.init_pose.expand(xf.shape[0], self.dof)
        for _ in range(self.n_iter):
            xc = torch.cat([xf, pred_pose], dim=1)
            xc = self._drop(self.fc_pose_1(xc), generator)
            xc = self._drop(self.fc_pose_2(xc), generator)
            pred_pose = self.decpose(xc) + pred_pose
        return pred_pose

    def _rotation(self, xf, generator):
        """Rotation (B, rotation_dim): six Dense layers with a skip
        (direct_reg_rot), or n_iter weight-shared MLP steps from init_rot
        that add 6-D vectors or compose matrices (rot_iterative_matmul)."""
        if self.direct_reg_rot:
            xc1 = self.fc_rot_1(xf)
            xc = xc1
            for i in range(2, 7):
                xc = getattr(self, f"fc_rot_{i}")(xc)
            return self.decrot(xc + xc1)
        pred_rot = self.init_rot.expand(xf.shape[0], self.rotation_dim)
        for _ in range(self.n_iter):
            xc = torch.cat([xf, pred_rot], dim=1)
            xc = self._drop(self.fc_rot_1(xc), generator)
            xc = self._drop(self.fc_rot_2(xc), generator)
            if self.rot_iterative_matmul:
                pred_rot = rotmat_to_rot6d(rot6d_to_rotmat(self.decrot(xc))
                                           @ rot6d_to_rotmat(pred_rot))
            else:
                pred_rot = self.decrot(xc) + pred_rot
        return pred_rot

    def forward(self, x_reg, x_root, k_value, K,
                generator: Optional[torch.Generator] = None):
        """x_reg, x_root: (B, 3, S, S) float crops in [0, 1]; k_value (B,);
        K (B, 3, 3) intrinsics of the reg crop; generator: the dropout masks'
        source, needed in train mode when p_dropout > 0.

        Returns a dict: pose (B, dof), rot (B, rotation_dim), trans (B, 3),
        root_uv (B, 2) pixels, depth (B, 1) metres, uvd (B, K, 3),
        xyz_int (B, K, 3) [, depths (B, len(kps_need_depth)) with
        multi_kp].
        """
        B = x_reg.shape[0]
        with self._autocast(x_reg):
            img_feat = self._root_feature(x_root)
            hm, xf, x_out = self._reg_features(x_reg)
        xf = xf.float()

        # ---- root depth ----
        depths = self._depths(img_feat, k_value)
        pred_depth = self._root_depth(depths)
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
        out = dict(pose=self._pose(xf, x_out, generator),
                   rot=self._rotation(xf, generator), trans=pred_trans,
                   root_uv=pred_root_uv, depth=pred_depth, uvd=pred_uvd,
                   xyz_int=pred_xyz_int)
        if self.multi_kp:
            out["depths"] = depths
        return out
