"""Model and robot construction from a `FullNetConfig`.

Port of `build_fullnet`, `make_robot` and `crop_sizes` from
`horopose_tpu/pipelines/common.py`. The dataclass replaces the YAML config;
its defaults are the panda flagship (`configs/panda/full.yaml`), model and
stage-2 training alike. A key that file leaves out takes the JAX package's
default (`horopose_tpu/config.py`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from horopose_tpu_torch import constants as C
from horopose_tpu_torch.kinematics.robot import Robot
from horopose_tpu_torch.models.full_net import FullNet


@dataclasses.dataclass
class FullNetConfig:
    urdf_robot_name: str = "panda"
    backbone_name: str = "resnet50"
    rootnet_backbone_name: str = "hrnet32"
    image_size: int = 256
    rootnet_image_size: Optional[int] = None   # None: image_size
    depth_dim: int = 64
    bbox_3d_shape: Tuple[float, float, float] = (1300.0, 1300.0, 1300.0)
    reference_keypoint_id: int = 3
    fix_root: bool = True
    n_iter: int = 4
    p_dropout: float = 0.5
    rotation_dim: int = 6

    # ---- stage-2 training ----
    batch_size: int = 64
    lr: float = 1e-4
    weight_decay: float = 0.0
    use_schedule: bool = True
    schedule_type: str = "exponential"
    n_epochs_warmup: int = 0
    start_decay: float = 45
    end_decay: float = 100
    final_decay: float = 0.01
    exponent: float = 0.95
    step_decay: float = 0.1
    step: int = 5
    clip_gradient: float = 5.0
    # ground truth
    use_extended_bbox: bool = True
    use_origin_bbox: bool = False
    use_joint_valid_mask: bool = False
    known_joint: bool = False
    fix_mask: bool = False
    joint_individual_weights: Optional[Sequence[float]] = None
    # the 10 losses
    pose_loss_func: str = "mse"
    rot_loss_func: str = "mse"
    trans_loss_func: str = "l2norm"
    uv_loss_func: str = "l2norm"
    depth_loss_func: str = "l1"
    pose_loss_weight: float = 1.0
    rot_loss_weight: float = 1.0
    trans_loss_weight: float = 1.0
    uv_loss_weight: float = 1.0
    depth_loss_weight: float = 10.0
    kp2d_loss_weight: float = 10.0
    kp3d_loss_weight: float = 10.0
    kp2d_int_loss_weight: float = 10.0
    kp3d_int_loss_weight: float = 10.0
    align_3d_loss_weight: float = 0.0


def crop_sizes(cfg: FullNetConfig) -> Tuple[int, int]:
    """(rootnet crop side, regression crop side); the model's heatmap
    geometry follows the regression crop."""
    root = cfg.rootnet_image_size or cfg.image_size
    return int(root), int(cfg.image_size)


def make_robot(cfg: FullNetConfig, device="cuda") -> Robot:
    return Robot(cfg.urdf_robot_name, device=device)


def build_fullnet(cfg: FullNetConfig,
                  dtype: torch.dtype = torch.float32) -> FullNet:
    robot_type = cfg.urdf_robot_name
    return FullNet(
        dof=C.DOF[robot_type],
        num_keypoints=C.NUM_KEYPOINTS[robot_type],
        backbone_name=cfg.backbone_name,
        rootnet_backbone_name=cfg.rootnet_backbone_name,
        image_size=crop_sizes(cfg)[1], depth_dim=cfg.depth_dim,
        bbox_3d_shape=tuple(cfg.bbox_3d_shape),
        reference_keypoint_id=cfg.reference_keypoint_id,
        fix_root=cfg.fix_root, n_iter=cfg.n_iter, p_dropout=cfg.p_dropout,
        rotation_dim=cfg.rotation_dim,
        init_pose=tuple(C.initial_joint_vector("mean", robot_type).tolist()),
        # identity rotation in the configured representation
        init_rot=(1.0, 0.0, 0.0, 0.0) if cfg.rotation_dim == 4
        else (1.0, 0.0, 0.0, 0.0, 1.0, 0.0),
        dtype=dtype)


def random_state_dict(model: nn.Module, seed: int) -> Dict[str, torch.Tensor]:
    """Random weights for `model` drawn from a CPU `torch.Generator(seed)`,
    so they do not depend on the device: He-normal conv and linear weights,
    small biases, random BatchNorm running statistics, and BatchNorm scales
    near 0.5, which keep eval-mode activations O(1) through the deep
    residual and fuse sums (near 1 they grow to ~1e9 by the last layer)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for key, value in model.state_dict().items():
        shape = tuple(value.shape)
        if key.endswith("num_batches_tracked"):
            out[key] = torch.zeros_like(value, device="cpu")
        elif key.endswith("running_var"):
            out[key] = 0.5 + torch.rand(shape, generator=g)
        elif key.endswith("running_mean"):
            out[key] = 0.1 * torch.randn(shape, generator=g)
        elif value.dim() == 1 and key.endswith(".weight"):   # BN scale
            out[key] = 0.5 + 0.05 * torch.randn(shape, generator=g)
        elif value.dim() == 1:                               # biases
            out[key] = 0.01 * torch.randn(shape, generator=g)
        else:
            fan_in = math.prod(shape[1:])
            out[key] = torch.randn(shape, generator=g) * math.sqrt(2.0 / fan_in)
    return out
