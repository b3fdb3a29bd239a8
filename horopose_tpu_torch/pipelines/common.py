"""Shared pipeline plumbing: model and robot construction, seeding, and
the DREAM data loaders.

Port of `horopose_tpu/pipelines/common.py`: `build_fullnet`, `make_robot`,
`crop_sizes`, `set_seed`, `make_pnp_fn`, `apply_pretrained_backbone` (the
ImageNet backbone loader) and `get_dataloaders` (the train
set from cfg.train_ds_names; the test sets found by the train_dr -> test_dr
/ test_photo naming convention, plus the four real Panda camera sets when
they are on disk). The loaders run in one process: the rank-strided
sampler of a multi-process run waits for the port's data parallelism.

`FullNetConfig` holds the keys of the YAML config that the port's FullNet
and its stage-2 steps read; its defaults are the panda flagship
(`configs/panda/full.yaml`), model and stage-2 training alike. A key that
file leaves out takes the JAX package's default (`horopose_tpu/config.py`).
`FullNetConfig.from_cfg` takes them from a config that `config.make_cfg`
read.
"""

from __future__ import annotations

import dataclasses
import math
import os
import random
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from horopose_tpu_torch import constants as C
from horopose_tpu_torch.data.dream import DreamDataset
from horopose_tpu_torch.data.samplers import (DataLoader, PartialSampler,
                                              WeightedRandomSampler)
from horopose_tpu_torch.kinematics.robot import Robot
from horopose_tpu_torch.models.full_net import FullNet

REAL_DS_SHORTS = ("azure", "kinect", "realsense", "orb")


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
    # the variant heads (models/full_net.py); no shipped config sets them
    direct_reg_rot: bool = False
    rot_iterative_matmul: bool = False
    reg_joint_map: bool = False
    # empty: (256, 256, 256), as the JAX package builds it
    joint_conv_dim: Sequence[int] = dataclasses.field(default_factory=list)
    add_fc: bool = False
    multi_kp: bool = False
    kps_need_depth: Optional[Sequence[int]] = None

    # ---- stage-2 training ----
    batch_size: int = 64
    lr: float = 1e-4
    weight_decay: float = 0.0
    use_schedule: bool = True
    schedule_type: str = "exponential"
    n_epochs_warmup: int = 0
    start_decay: float = 45.0
    end_decay: float = 100.0
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
    # a stage-1 DepthNet checkpoint for the rootnet branch, and ImageNet
    # weights for either backbone (pipelines/train_full.py::
    # init_fullnet_state)
    pretrained_rootnet: Optional[str] = None
    backbone_pretrained: Optional[str] = None
    rootnet_backbone_pretrained: Optional[str] = None

    @classmethod
    def from_cfg(cls, cfg: Mapping) -> "FullNetConfig":
        """The fields' values from a `config.make_cfg` config, each coerced
        to its field's type (`image_size : 256.0` -> 256; a field without a
        default value, such as a list, takes the value as read); keys
        without a field are not read."""
        values = {}
        if cfg.get("other_image_size"):
            # the model's heatmap geometry follows the regression crop
            values["image_size"] = _size_hw(cfg["other_image_size"], None)[0]
        for field in dataclasses.fields(cls):
            if field.name not in cfg or field.name in values:
                continue
            v, default = cfg[field.name], field.default
            if v is None or default is None or default is dataclasses.MISSING:
                values[field.name] = v
            elif isinstance(default, tuple):
                values[field.name] = tuple(float(e) for e in v)
            else:
                values[field.name] = type(default)(v)
        return cls(**values)


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
        rotation_dim=cfg.rotation_dim, direct_reg_rot=cfg.direct_reg_rot,
        rot_iterative_matmul=cfg.rot_iterative_matmul,
        reg_joint_map=cfg.reg_joint_map,
        joint_conv_dim=tuple(int(c) for c in cfg.joint_conv_dim)
        or (256, 256, 256),
        joint_bounds=C.JOINT_BOUNDS[robot_type] if cfg.reg_joint_map
        else None,
        add_fc=cfg.add_fc, multi_kp=cfg.multi_kp,
        kps_need_depth=tuple(int(k) for k in cfg.kps_need_depth)
        if cfg.kps_need_depth else None,
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


def set_seed(seed: int = C.GLOBAL_SEED):
    """Seed the global `random` and numpy generators."""
    random.seed(seed)
    np.random.seed(seed)


def make_pnp_fn(ds_names):
    """The pseudo-ground-truth rotation of a set: None for a synthetic set,
    where TCO is the rotation ground truth; for a real set `ops.pnp.pnp`,
    PnP of the annotated 2D keypoints against FK 3D points. Training and
    validation key it on the train set's name, the test harness on the set
    under evaluation."""
    if "synth" in str(ds_names):
        return None
    from horopose_tpu_torch.ops.pnp import pnp
    return pnp


def _backbone_artifact(path: str, backbone_name: str):
    """A backbone weight file -> (state dict under the backbone's own
    names, source leaves that have no name there): a `.msgpack` of flax
    variables (`tools/convert.py`), or a raw torch state dict (`.pth`,
    `.pt`, `.pk`), whose keys are already the port's (a `state_dict` or
    `model_state_dict` entry is unwrapped)."""
    if path.endswith(".msgpack"):
        from horopose_tpu_torch.core.checkpoint import read_flax_msgpack
        from horopose_tpu_torch.tools.jax_weights import \
            backbone_state_dict_from_jax
        with open(path, "rb") as f:
            tree = read_flax_msgpack(f.read())
        return backbone_state_dict_from_jax(tree.get("params", {}),
                                            tree.get("batch_stats", {}),
                                            backbone_name)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("model_state_dict", "state_dict"):
        if isinstance(payload, dict) and key in payload:
            payload = payload[key]
    return {k: v for k, v in payload.items()
            if isinstance(v, torch.Tensor)}, []


def apply_pretrained_backbone(model: nn.Module, weights_path: str,
                              backbone_name: str, dst_prefix: str,
                              tag: str = "") -> Tuple[int, int, list]:
    """Initialise the backbone `dst_prefix` of `model` (e.g.
    "reg_backbone") from pretrained weights, in place. The merge is
    lenient, as the reference's strict=False load: every source tensor
    whose name exists under the prefix with the same shape is copied, the
    rest is skipped (BatchNorm's `num_batches_tracked` is not counted).
    Returns (parameters loaded, BatchNorm statistics loaded, skipped
    names); raises when nothing matched."""
    src, skipped = _backbone_artifact(weights_path, backbone_name)
    target = model.state_dict()
    if not any(k.startswith(dst_prefix + ".") for k in target):
        raise KeyError(f"no backbone {dst_prefix!r} in the model")
    n_params = n_stats = 0
    skipped = list(skipped)
    for name, value in src.items():
        if name.endswith("num_batches_tracked"):
            continue
        key = f"{dst_prefix}.{name}"
        if key not in target or target[key].shape != value.shape:
            skipped.append(name)
            continue
        target[key] = value.to(target[key].dtype)
        if name.endswith(("running_mean", "running_var")):
            n_stats += 1
        else:
            n_params += 1
    if n_params == 0:
        raise ValueError(
            f"pretrained backbone {weights_path!r} matched ZERO tensors of "
            f"{dst_prefix!r}: wrong backbone_name or artifact?")
    model.load_state_dict(target)
    print(f"[pretrained{tag}] {weights_path} -> {dst_prefix}: {n_params} "
          f"params + {n_stats} batch_stats loaded, {len(skipped)} skipped")
    return n_params, n_stats, skipped


def _resolve_cache_dir(cfg, path) -> str:
    """Per-dataset decode-cache directory (its contents depend only on the
    jpgs, so the key is just the dataset's name); "" when off."""
    if not cfg.get("decode_cache"):
        return ""
    root = str(cfg.get("decode_cache_dir") or
               os.environ.get("HOROPOSE_CACHE_DIR") or
               os.path.join(str(path), ".decode_cache"))
    root_abs, path_abs = os.path.abspath(root), os.path.abspath(str(path))
    # separator-boundary containment: /data/dream-v2 is NOT inside
    # /data/dream (a bare startswith would say it is)
    if root_abs == path_abs or root_abs.startswith(path_abs + os.sep):
        return root  # already inside the dataset dir: no name needed
    return os.path.join(root, os.path.basename(os.path.normpath(str(path))))


def _size_hw(value, fallback) -> tuple:
    """Normalize a size knob (scalar / (h, w) / None) to an int pair."""
    if value is None:
        value = fallback
    if isinstance(value, (tuple, list)):
        return (int(value[0]), int(value[1]))
    return (int(value), int(value))


def dataset_crop_hw(cfg) -> tuple:
    """(rootnet_hw, other_hw) of a `config.make_cfg` config: the two crops
    are sized independently and both default to cfg.image_size. Non-square
    crops are rejected: the heatmap geometry is image_size // 4 in both
    axes."""
    sizes = (_size_hw(cfg.get("rootnet_image_size"), cfg.image_size),
             _size_hw(cfg.get("other_image_size"), cfg.image_size))
    for tag, (h, w) in zip(("rootnet_image_size", "other_image_size"), sizes):
        if h != w:
            raise ValueError(
                f"{tag}=({h},{w}) is non-square; FullNet assumes square "
                "crops (heatmap geometry is image_size//4 in both axes)")
    return sizes


def _mk_dataset(cfg, path, train: bool) -> DreamDataset:
    rootnet_hw, other_hw = dataset_crop_hw(cfg)
    return DreamDataset(
        path,
        decode_cache_dir=_resolve_cache_dir(cfg, path),
        padding=bool(cfg.get("padding")),
        rootnet_resize_hw=rootnet_hw,
        other_resize_hw=other_hw,
        color_jitter=cfg.jitter if train else False,
        rgb_augmentation=cfg.other_aug if train else False,
        occlusion_augmentation=cfg.occlusion if train else False,
        occlu_p=cfg.occlu_p,
        extend_ratio=cfg.extend_ratio,
        flip=cfg.rootnet_flip if train else False,
        process_truncation=bool(cfg.fix_truncation),
        truncation_padding=tuple(cfg.truncation_padding),
    )


def get_dataloaders(cfg, device="cuda") -> Dict:
    """The train loader and {dataset name: eval loader} of a
    `config.make_cfg` config; batches are pinned when `device` is a CUDA
    device. Eval sets that are not on disk are skipped."""
    train_path = cfg.train_ds_names
    robot = cfg.urdf_robot_name
    pin = torch.device(device).type == "cuda"
    out: Dict = {"test": {}}

    ds_train = _mk_dataset(cfg, train_path, train=True)
    if len(ds_train) == 0:
        raise FileNotFoundError(
            f"no DREAM samples (*.jpg + *.json) found under {train_path!r}; "
            "set HOROPOSE_DATA_DIR or fix train_ds_names in the config")
    sampler = PartialSampler(ds_train, cfg.epoch_size)
    batch_size = int(cfg.batch_size)
    if cfg.get("resample"):
        # weighted resampling; the weights file is a user-supplied artifact
        weights_path = os.path.join("unit_test", "z_weights.npy")
        if os.path.exists(weights_path):
            sampler = WeightedRandomSampler(
                np.load(weights_path),
                num_samples=min(cfg.epoch_size, len(ds_train)))
        else:
            print(f"[data] resample=True but {weights_path} missing; "
                  "falling back to uniform sampling")
    out["train"] = DataLoader(ds_train, batch_size=batch_size,
                              sampler=sampler,
                              num_workers=cfg.n_dataloader_workers,
                              drop_last=True, pin_memory=pin)
    if len(out["train"]) == 0:
        # drop_last + a sampler shorter than one batch = silent no-op
        # epochs (loss meters log 0.0); name the cause loudly
        print(f"[data] WARNING: zero train batches per epoch — sampler "
              f"yields {len(sampler)} indices (epoch_size={cfg.epoch_size}, "
              f"dataset={len(ds_train)}) < batch_size {batch_size}; "
              "every epoch will be a no-op")
    out["train_dataset"] = ds_train

    candidates = {"dr": train_path.replace("train_dr", "test_dr")}
    if robot != "baxter":
        candidates["photo"] = train_path.replace("train_dr", "test_photo")
    if robot == "panda":
        for short in REAL_DS_SHORTS:
            candidates[short] = os.path.join(
                os.path.dirname(os.path.dirname(train_path)),
                "real", f"panda-3cam_{short}" if short != "orb"
                else "panda-orb")
    for name, path in candidates.items():
        if os.path.isdir(path) and os.path.abspath(path) != \
                os.path.abspath(train_path):
            ds = _mk_dataset(cfg, path, train=False)
            if len(ds):
                out["test"][name] = DataLoader(
                    ds, batch_size=batch_size,
                    num_workers=cfg.n_dataloader_workers, drop_last=False,
                    pin_memory=pin)
    return out
