"""The train and eval steps of the full network (stage 2) and DepthNet
(stage 1).

Port of `horopose_tpu/core/engine.py`: the per-epoch LR schedule and the
optimizer (:53-96), ground-truth assembly on the device (:103-173), the
10-loss battery (:180-282), FullNet's train and eval steps (:316-351,
:449-479), and DepthNet's ground truth, loss and steps (:354-446).

The JAX step is one jitted function over an immutable TrainState. Here the
step runs eagerly on the model in place: the train-mode forward updates the
BatchNorm running statistics, backward fills `.grad`, and the optimizer
updates the parameters. Batches keep the JAX package's layout: nested
`root` / `other` dicts of tensors with uint8 NHWC images, as
`batch_to_torch` makes them from the JAX `DataLoader`'s numpy batches.

On a real set the rotation ground truth is PnP of the annotated 2D
keypoints against FK (`pnp_fn`, `ops/pnp.py`). Not ported yet: the
quaternion and multi-keypoint variants (ROADMAP queue 1 item 5).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from horopose_tpu_torch import constants as C
from horopose_tpu_torch.core import losses as L
from horopose_tpu_torch.kinematics.robot import Robot
from horopose_tpu_torch.ops.rotations import (geodesic_distance,
                                              rot6d_to_rotmat, rot_to_rotmat,
                                              rotmat_to_rot6d)
from horopose_tpu_torch.ops.transforms import k_value_from_bbox, project_points

Batch = Mapping[str, object]


def batch_to_torch(batch: Mapping, device) -> Dict:
    """A nested dict of numpy arrays (the JAX `DataLoader`'s batch) ->
    the same dict of tensors on `device`."""
    return {k: batch_to_torch(v, device) if isinstance(v, Mapping)
            else torch.as_tensor(np.asarray(v), device=device)
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# optimizer / schedule


def schedule_ratio(cfg, epoch: int) -> float:
    """Per-epoch LR ratio (the reference's lr lambdas)."""
    if not cfg.use_schedule:
        return 1.0
    e = float(epoch)
    if e < cfg.n_epochs_warmup:
        return (e + 1.0) / max(float(cfg.n_epochs_warmup), 1.0)
    start, end = float(cfg.start_decay), float(cfg.end_decay)
    if cfg.schedule_type == "linear":
        final = float(cfg.final_decay)
        if e <= start:
            return 1.0
        if e <= end:
            return (end - final * start - (1.0 - final) * e) / (end - start)
        return final
    if cfg.schedule_type == "exponential":
        if e <= start:
            return 1.0
        return float(cfg.exponent) ** (min(e, end) - start)
    if cfg.schedule_type == "everyXepoch":
        return float(cfg.step_decay) ** math.floor(min(e, end) /
                                                   float(cfg.step))
    return 1.0


def make_optimizer(cfg, params: Sequence[nn.Parameter], steps_per_epoch: int
                   ) -> Tuple[torch.optim.Adam, torch.optim.lr_scheduler.LambdaLR]:
    """Adam with coupled L2 (`weight_decay` adds w * param to the gradient
    before the moments, as optax's add_decayed_weights before adam) and an
    LR of lr * schedule_ratio(step // steps_per_epoch). The scheduler steps
    once per optimizer step, after it, so the first update uses epoch 0, as
    optax's count starts at 0. Clipping is `clip_by_global_norm_`, called
    by the train step between backward and the optimizer."""
    adam = torch.optim.Adam(params, lr=float(cfg.lr),
                            weight_decay=float(cfg.weight_decay or 0.0))
    spe = max(int(steps_per_epoch), 1)
    sched = torch.optim.lr_scheduler.LambdaLR(
        adam, lambda step: schedule_ratio(cfg, step // spe))
    return adam, sched


def clip_by_global_norm_(params: Sequence[nn.Parameter], max_norm: float
                         ) -> torch.Tensor:
    """optax.clip_by_global_norm on the `.grad`s, in place: scale every
    gradient by max_norm / ||g|| when the global norm ||g|| is at least
    max_norm, else leave them. No epsilon is added to the norm (unlike
    torch's clip_grad_norm_). Returns ||g|| before clipping, on the device,
    without a host sync."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, torch.clamp(max_norm / norm, max=1.0))
    return norm


# ---------------------------------------------------------------------------
# GT preparation (device-side)


def prepare_gt(cfg, robot: Robot, batch: Batch,
               pnp_fn: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
    """Assemble the ground truth on the batch's device. pnp_fn, given on a
    real set, replaces TCO's rotation by PnP of the annotated 2D keypoints
    (`keypoints_2d_original`) against FK world points, at `K_original`."""
    if int(cfg.rotation_dim) != 6:
        raise NotImplementedError(
            f"rotation_dim {cfg.rotation_dim} needs rotmat_to_quat, not "
            f"ported yet (ROADMAP queue 1 item 5)")
    other, root = batch["other"], batch["root"]
    TCO = batch["TCO"].float()
    gt_pose = batch["jointpose"].float()
    gt_keypoints3d = other["keypoints_3d"].float()
    gt_keypoints2d = other["keypoints_2d"].float()
    valid_mask = batch["valid_mask"].float()
    valid_mask_crop = other["valid_mask_crop"].float()
    root_K = root["K"].float()
    K_original = batch["K_original"].float()

    gt_rot = rotmat_to_rot6d(TCO[:, :3, :3])
    gt_trans = TCO[:, :3, 3]
    if pnp_fn is not None:
        R_pnp, _ = pnp_fn(batch["keypoints_2d_original"].float(),
                          robot.get_keypoints_only_fk(gt_pose), K_original)
        gt_rot = rotmat_to_rot6d(R_pnp)
    ref = int(cfg.reference_keypoint_id)
    if ref == 0:
        gt_root_trans = gt_trans
        gt_root_rot = gt_rot
    else:
        gt_root_trans = gt_keypoints3d[:, ref, :]
        gt_root_rot = robot.get_rotation_at_specific_root(
            gt_pose, gt_rot, gt_trans, root=ref)

    # the k value prior
    if cfg.use_extended_bbox:
        bboxes = root["bbox_gt2d_extended"].float()
        fx, fy = root_K[:, 0, 0], root_K[:, 1, 1]
    elif cfg.use_origin_bbox:
        bboxes = batch["bbox_strict_bounded_original"].float()
        fx, fy = K_original[:, 0, 0], K_original[:, 1, 1]
    else:
        bboxes = root["bbox_strict_bounded"].float()
        fx, fy = root_K[:, 0, 0], root_K[:, 1, 1]
    k_values = k_value_from_bbox(bboxes, fx.abs(), fy.abs())

    gt_pose_before_mask = gt_pose
    if cfg.use_joint_valid_mask:
        robot_type = cfg.urdf_robot_name
        joint_valid = valid_mask[:, C.JOINT_TO_KP[robot_type]]
        mean_joints = torch.as_tensor(
            C.initial_joint_vector("mean", robot_type),
            device=gt_pose.device)[None]
        gt_pose = gt_pose * joint_valid + mean_joints * (1 - joint_valid)

    return dict(
        gt_pose=gt_pose, gt_pose_before_mask=gt_pose_before_mask,
        gt_rot=gt_rot, gt_root_rot=gt_root_rot, gt_trans=gt_trans,
        gt_root_trans=gt_root_trans, gt_root_depth=gt_root_trans[:, 2:3],
        gt_root_uv=gt_keypoints2d[:, ref, 0:2], gt_keypoints3d=gt_keypoints3d,
        gt_keypoints2d=gt_keypoints2d, valid_mask=valid_mask,
        valid_mask_crop=valid_mask_crop, k_values=k_values,
    )


# ---------------------------------------------------------------------------
# losses


def compute_full_losses(cfg, preds: Mapping[str, torch.Tensor],
                        gts: Mapping[str, torch.Tensor],
                        other_K: torch.Tensor,
                        row_mask: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The 10-loss engine: (weighted sum, the 10 named losses).

    row_mask, when given, is the eval pipelines' (B,) `_valid` pad mask:
    every loss becomes a masked mean, so a batch padded with duplicated
    rows logs exactly the loss of the unpadded batch. Training passes None.
    """
    if "depths" in preds:       # the per-keypoint depths of a multi_kp head
        raise NotImplementedError("multi_kp losses are not ported yet "
                                  "(ROADMAP queue 1 item 5)")
    image_size = float(cfg.image_size)
    pred_pose = preds["pose"]
    gt_pose = gts["gt_pose"]
    if cfg.known_joint:
        pred_pose = gt_pose
    if cfg.joint_individual_weights is not None:
        jw = torch.as_tensor(cfg.joint_individual_weights, dtype=torch.float32,
                             device=gt_pose.device).reshape(1, -1)
        pred_pose = pred_pose * jw
        gt_pose = gt_pose * jw

    loss_pose = L.elementwise_loss(cfg.pose_loss_func, pred_pose, gt_pose,
                                   row_mask=row_mask)
    if cfg.rot_loss_func == "mat_mse":
        loss_rot = L.mse(rot6d_to_rotmat(preds["rot"]),
                         rot6d_to_rotmat(gts["gt_root_rot"]),
                         row_mask=row_mask)
    else:
        loss_rot = L.elementwise_loss(cfg.rot_loss_func, preds["rot"],
                                      gts["gt_root_rot"], row_mask=row_mask)
    loss_depth = L.elementwise_loss(cfg.depth_loss_func, preds["depth"],
                                    gts["gt_root_depth"], row_mask=row_mask)

    ref = int(cfg.reference_keypoint_id)
    if cfg.uv_loss_func == "l2norm":
        mask = gts["valid_mask_crop"][:, ref]
        if row_mask is not None:
            mask = mask * row_mask
        err = torch.linalg.norm(
            (preds["root_uv"] - gts["gt_root_uv"]) / image_size, dim=1)
        loss_uv = (err * mask).sum() / torch.clamp((mask != 0).sum(), min=1)
    else:
        loss_uv = L.elementwise_loss(cfg.uv_loss_func,
                                     preds["root_uv"] / image_size,
                                     gts["gt_root_uv"] / image_size,
                                     row_mask=row_mask)

    if cfg.trans_loss_func == "l2norm":
        loss_trans = L.trans_l2norm_with_outlier_downweight(
            preds["trans"], gts["gt_root_trans"], row_mask=row_mask)
    else:
        loss_trans = L.elementwise_loss(cfg.trans_loss_func, preds["trans"],
                                        gts["gt_root_trans"],
                                        row_mask=row_mask)

    loss_error3d = L.masked_norm_loss(preds["xyz_fk"], gts["gt_keypoints3d"],
                                      row_mask=row_mask)
    kp2d_fk = project_points(other_K, preds["xyz_fk"]) / image_size
    kp2d_int = project_points(other_K, preds["xyz_int"]) / image_size
    gt_kp2d_n = gts["gt_keypoints2d"] / image_size
    vm = gts["valid_mask_crop"]
    loss_error2d = L.masked_norm_loss(kp2d_fk, gt_kp2d_n, vm,
                                      row_mask=row_mask)
    loss_error2d_int = L.masked_norm_loss(kp2d_int, gt_kp2d_n, vm,
                                          row_mask=row_mask)
    loss_error3d_int = L.masked_norm_loss(
        preds["xyz_int"], gts["gt_keypoints3d"],
        vm if cfg.fix_mask else None, row_mask=row_mask)
    loss_error3d_align = L.masked_norm_loss(
        preds["xyz_fk"], preds["xyz_int"], vm if cfg.fix_mask else None,
        row_mask=row_mask)

    loss = (cfg.pose_loss_weight * loss_pose +
            cfg.rot_loss_weight * loss_rot +
            cfg.uv_loss_weight * loss_uv +
            cfg.depth_loss_weight * loss_depth +
            cfg.trans_loss_weight * loss_trans +
            cfg.kp2d_loss_weight * loss_error2d +
            cfg.kp3d_loss_weight * loss_error3d +
            cfg.kp2d_int_loss_weight * loss_error2d_int +
            cfg.kp3d_int_loss_weight * loss_error3d_int +
            cfg.align_3d_loss_weight * loss_error3d_align)
    loss_dict = dict(
        loss_joint=loss_pose, loss_rot=loss_rot, loss_uv=loss_uv,
        loss_depth=loss_depth, loss_trans=loss_trans,
        loss_error2d=loss_error2d, loss_error3d=loss_error3d,
        loss_error2d_int=loss_error2d_int, loss_error3d_int=loss_error3d_int,
        loss_error3d_align=loss_error3d_align,
    )
    return loss, loss_dict


# ---------------------------------------------------------------------------
# the train and eval steps


def _normalize_images(x: torch.Tensor) -> torch.Tensor:
    """uint8 (B, S, S, 3) -> float32 (B, 3, S, S) in [0, 1]."""
    return (x.permute(0, 3, 1, 2).float() / 255.0).contiguous()


def _forward(cfg, model: nn.Module, robot: Robot, batch: Batch,
             gts: Mapping[str, torch.Tensor],
             generator: Optional[torch.Generator] = None):
    """The model's forward in its current mode, plus the FK lift."""
    x_reg = _normalize_images(batch["other"]["images"])
    x_root = _normalize_images(batch["root"]["images"])
    other_K = batch["other"]["K"].float()
    outs = model(x_reg, x_root, gts["k_values"], other_K, generator=generator)
    pose_for_fk = gts["gt_pose"] if cfg.known_joint else outs["pose"]
    outs["xyz_fk"] = robot.get_keypoints_root(
        pose_for_fk, outs["rot"], outs["trans"],
        root=int(cfg.reference_keypoint_id))
    return outs, other_K


def _update(cfg, loss: torch.Tensor, params: Sequence[nn.Parameter],
            optimizer: torch.optim.Optimizer,
            scheduler: torch.optim.lr_scheduler.LRScheduler) -> None:
    """Backward, a zero gradient for a parameter that got none (JAX
    differentiates every parameter), global-norm clipping of the raw
    gradients, then the optimizer and scheduler steps."""
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if cfg.clip_gradient:
        clip_by_global_norm_(params, float(cfg.clip_gradient))
    optimizer.step()
    scheduler.step()


def build_full_train_step(cfg, model: nn.Module, robot: Robot,
                          optimizer: torch.optim.Optimizer,
                          scheduler: torch.optim.lr_scheduler.LRScheduler,
                          pnp_fn: Optional[Callable] = None):
    """Returns step(batch, generator) -> logs, the loss and the 10 named
    losses as device scalars (read them on the host only when needed).

    One step: train-mode forward (BatchNorm batch statistics, its running
    statistics updated in place; dropout from `generator`), the FK lift,
    the losses, and `_update`: backward, clipping, the optimizer and
    scheduler steps."""
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch: Batch, generator: Optional[torch.Generator]
             ) -> Dict[str, torch.Tensor]:
        model.train()
        gts = prepare_gt(cfg, robot, batch, pnp_fn)
        preds, other_K = _forward(cfg, model, robot, batch, gts, generator)
        loss, loss_dict = compute_full_losses(cfg, preds, gts, other_K)
        _update(cfg, loss, params, optimizer, scheduler)
        return {k: v.detach() for k, v in dict(loss=loss, **loss_dict).items()}

    return step


def prepare_depth_gt(cfg, batch: Batch) -> Dict[str, torch.Tensor]:
    """Ground truth of the DepthNet stage: the root's camera-frame position
    and depth (metres), the k prior from the configured bbox, and the
    root's visibility in the crop."""
    root = batch["root"]
    gt_keypoints3d = root["keypoints_3d"].float()
    root_K = root["K"].float()
    K_original = batch["K_original"].float()
    ref = int(cfg.reference_keypoint_id)
    gt_root_trans = (batch["TCO"].float()[:, :3, 3] if ref == 0
                     else gt_keypoints3d[:, ref, :])
    if cfg.use_extended_bbox:
        bboxes = root["bbox_gt2d_extended"].float()
        fx, fy = root_K[:, 0, 0], root_K[:, 1, 1]
    elif cfg.use_origin_bbox:
        bboxes = batch["bbox_strict_bounded_original"].float()
        fx, fy = K_original[:, 0, 0], K_original[:, 1, 1]
    else:
        bboxes = root["bbox_strict_bounded"].float()
        fx, fy = root_K[:, 0, 0], root_K[:, 1, 1]
    return dict(gt_root_trans=gt_root_trans,
                gt_root_depth=gt_root_trans[:, 2:3],
                k_values=k_value_from_bbox(bboxes, fx.abs(), fy.abs()),
                uv_valid_mask=root["valid_mask_crop"].float()[:, ref:ref + 1])


def depthnet_forward_loss(cfg, model: nn.Module, batch: Batch,
                          gts: Mapping[str, torch.Tensor],
                          row_mask: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The model's forward in its current mode on the root crops ->
    (loss, predicted depth (B, 1) in metres). The model gives millimetres;
    with the xy branch its (x, y) are held to the root's (x, y) where the
    root is visible in the crop."""
    out = model(_normalize_images(batch["root"]["images"]), gts["k_values"])
    xy = bool(cfg.use_rootnet_xy_branch)
    pred_depth = (out[:, 2:3] if xy else out) / 1000.0
    loss = L.elementwise_loss(cfg.depth_loss_func, pred_depth,
                              gts["gt_root_depth"], row_mask=row_mask)
    if xy:
        m = gts["uv_valid_mask"]
        loss = loss + L.elementwise_loss(
            cfg.xy_loss_func, out[:, 0:2] * m,
            gts["gt_root_trans"][:, 0:2] * m, row_mask=row_mask)
    return loss, pred_depth


def build_depthnet_train_step(cfg, model: nn.Module,
                              optimizer: torch.optim.Optimizer,
                              scheduler: torch.optim.lr_scheduler.LRScheduler):
    """Returns step(batch) -> {"loss": device scalar}: train-mode forward
    (BatchNorm batch statistics, running statistics updated in place), the
    loss, and `_update`. RootNet has no dropout, so the step takes no
    generator."""
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch: Batch) -> Dict[str, torch.Tensor]:
        model.train()
        gts = prepare_depth_gt(cfg, batch)
        loss, _ = depthnet_forward_loss(cfg, model, batch, gts)
        _update(cfg, loss, params, optimizer, scheduler)
        return dict(loss=loss.detach())

    return step


def build_depthnet_eval_step(cfg, model: nn.Module):
    """Returns evaluate(batch) -> {loss, error_depth (B,), pred_depth
    (B, 1)} in eval mode; a `_valid` (B,) pad mask in the batch makes the
    loss a masked mean over the valid rows."""

    @torch.no_grad()
    def evaluate(batch: Batch) -> Dict[str, torch.Tensor]:
        model.eval()
        gts = prepare_depth_gt(cfg, batch)
        row_mask = batch.get("_valid")
        if row_mask is not None:
            row_mask = row_mask.float()
        loss, pred_depth = depthnet_forward_loss(cfg, model, batch, gts,
                                                 row_mask)
        error_depth = (pred_depth[:, 0] - gts["gt_root_depth"][:, 0]).abs()
        return dict(loss=loss, error_depth=error_depth, pred_depth=pred_depth)

    return evaluate


def build_full_eval_step(cfg, model: nn.Module, robot: Robot,
                         pnp_fn: Optional[Callable] = None):
    """Returns evaluate(batch) -> (preds, gts, logs) in eval mode. A
    `_valid` (B,) entry in the batch, the pad mask of a final partial batch,
    makes every logged scalar a masked mean over the valid rows."""

    @torch.no_grad()
    def evaluate(batch: Batch):
        model.eval()
        gts = prepare_gt(cfg, robot, batch, pnp_fn)
        preds, other_K = _forward(cfg, model, robot, batch, gts)
        row_mask = batch.get("_valid")
        if row_mask is not None:
            row_mask = row_mask.float()
        loss, loss_dict = compute_full_losses(cfg, preds, gts, other_K,
                                              row_mask=row_mask)
        # reference quirk, kept for parity with the JAX package: the logged
        # rotation_diff compares against the base rotation gt_rot, while
        # the loss uses the root-frame gt_root_rot
        rotation_diff = L.row_mean(
            geodesic_distance(rot_to_rotmat(preds["rot"]),
                              rot_to_rotmat(gts["gt_rot"])), row_mask)
        return preds, gts, dict(loss=loss, rotation_diff=rotation_diff,
                                **loss_dict)

    return evaluate
