"""The stage-2 train step in plain PyTorch.

One step on a DREAM-layout batch: the ground truth (the base pose moved to
the reference keypoint's link, the k prior from the extended bbox of the
root crop), the FullNet forward in train mode (BatchNorm on the batch's
statistics, dropout from the caller's generator), the FK lift, the ten
losses of the configuration and their weighted sum, the backward, the
gradients scaled to a global norm of at most `clip_gradient`, and Adam
written out (bias-corrected moments, no weight decay) at the learning
rate of the configuration's schedule.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import torch

from benchmark.reference.fullnet import FullNet, project, rot6d_to_rotmat
from benchmark.reference.robot import RobotFK

LOSS_TERMS = ("pose", "rot", "uv", "depth", "trans", "kp2d", "kp3d",
              "kp2d_int", "kp3d_int", "align_3d")


def _rot6d(R: torch.Tensor) -> torch.Tensor:
    return R[..., :2, :].reshape(*R.shape[:-2], 6)


def ground_truth(cfg: Mapping, robot: RobotFK, batch: Mapping
                 ) -> Dict[str, torch.Tensor]:
    """The targets and the k prior of a batch, for a reference keypoint
    other than the base."""
    ref = int(cfg["reference_keypoint_id"])
    if not (cfg["use_extended_bbox"] and ref > 0
            and not cfg["use_joint_valid_mask"] and not cfg["use_origin_bbox"]):
        raise NotImplementedError("the reference follows the extended-bbox "
                                  "k prior at a non-base reference keypoint")
    other, root = batch["other"], batch["root"]
    TCO = batch["TCO"].float()
    q = batch["jointpose"].float()
    R = rot6d_to_rotmat(_rot6d(TCO[:, :3, :3]))
    box = root["bbox_gt2d_extended"].float()
    side = torch.maximum((box[:, 2] - box[:, 0]).abs(),
                         (box[:, 3] - box[:, 1]).abs())
    rK = root["K"].float()
    kp3d = other["keypoints_3d"].float()
    return dict(
        pose=q, root_rot=_rot6d(robot.root_rotation(q, R, ref)),
        root_trans=kp3d[:, ref], kp3d=kp3d,
        kp2d=other["keypoints_2d"].float(),
        vis=other["valid_mask_crop"].float(),
        k=torch.sqrt(rK[:, 0, 0].abs() * rK[:, 1, 1].abs() * 1e6
                     / (side * side)))


def _masked_mean_norm(a, b, mask=None):
    err = torch.linalg.norm(a - b, dim=-1)
    if mask is None:
        return err.mean()
    return (err * mask).sum() / torch.clamp((mask != 0).sum(), min=1)


def _elementwise(kind: str, a, b):
    if kind == "mse":
        return ((a - b) ** 2).mean()
    if kind == "l1":
        return (a - b).abs().mean()
    raise NotImplementedError(kind)


def losses(cfg: Mapping, pred: Mapping, gt: Mapping, K_other: torch.Tensor
           ) -> Dict[str, torch.Tensor]:
    """The ten named losses (the 3-D ones without the crop mask)."""
    if cfg["uv_loss_func"] != "l2norm" or cfg["trans_loss_func"] != "l2norm":
        raise NotImplementedError("uv and trans losses other than l2norm")
    S = float(cfg["image_size"])
    ref = int(cfg["reference_keypoint_id"])
    mask = gt["vis"][:, ref]
    err = torch.linalg.norm((pred["root_uv"] - gt["kp2d"][:, ref]) / S, dim=1)
    t_err = torch.linalg.norm(pred["trans"] - gt["root_trans"], dim=-1)
    mean_t = t_err.mean()
    t_down = (t_err * torch.exp(-20.0 * t_err).detach()).mean()
    gt2d = gt["kp2d"] / S
    return dict(
        pose=_elementwise(cfg["pose_loss_func"], pred["pose"], gt["pose"]),
        rot=_elementwise(cfg["rot_loss_func"], pred["rot"], gt["root_rot"]),
        uv=(err * mask).sum() / torch.clamp((mask != 0).sum(), min=1),
        depth=_elementwise(cfg["depth_loss_func"], pred["depth"],
                           gt["root_trans"][:, 2:3]),
        trans=torch.where(mean_t > 0.5, t_down, mean_t),
        kp3d=_masked_mean_norm(pred["xyz_fk"], gt["kp3d"]),
        kp2d=_masked_mean_norm(project(K_other, pred["xyz_fk"]) / S, gt2d,
                               gt["vis"]),
        kp2d_int=_masked_mean_norm(project(K_other, pred["xyz_int"]) / S,
                                   gt2d, gt["vis"]),
        kp3d_int=_masked_mean_norm(pred["xyz_int"], gt["kp3d"]),
        align_3d=_masked_mean_norm(pred["xyz_fk"], pred["xyz_int"]))


def _images(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).float() / 255.0


def schedule_ratio(cfg: Mapping, epoch: int) -> float:
    """The learning rate's factor in an epoch: exponential decay after
    `start_decay`, held after `end_decay` (the configurations' schedule)."""
    if not cfg["use_schedule"]:
        return 1.0
    if cfg["schedule_type"] != "exponential" or cfg["n_epochs_warmup"]:
        raise NotImplementedError("an exponential schedule without warm-up")
    start, end = float(cfg["start_decay"]), float(cfg["end_decay"])
    e = float(epoch)
    return 1.0 if e <= start else float(cfg["exponent"]) ** (min(e, end)
                                                             - start)


class TrainReference:
    """The model, its Adam moments and the step count; `step` runs one
    step and returns the loss."""

    def __init__(self, cfg: Mapping, model: FullNet, robot: RobotFK,
                 steps_per_epoch: int, betas=(0.9, 0.999), eps: float = 1e-8):
        if float(cfg.get("weight_decay") or 0.0):
            raise NotImplementedError("weight decay")
        self.cfg, self.model, self.robot = cfg, model, robot
        self.params = dict(model.named_parameters())
        self.m = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.t = 0
        self.spe, self.betas, self.eps = steps_per_epoch, betas, eps
        self.grads: Dict[str, torch.Tensor] = {}
        self.parts: Dict[str, float] = {}

    def loss(self, batch: Mapping, generator: Optional[torch.Generator]
             ) -> torch.Tensor:
        cfg = self.cfg
        self.model.train()
        gt = ground_truth(cfg, self.robot, batch)
        K_other = batch["other"]["K"].float()
        pred = self.model(_images(batch["other"]["images"]),
                          _images(batch["root"]["images"]), gt["k"],
                          K_other, generator=generator)
        pred["xyz_fk"] = self.robot.keypoints_camera(
            pred["pose"], rot6d_to_rotmat(pred["rot"]), pred["trans"],
            int(cfg["reference_keypoint_id"]))
        parts = losses(cfg, pred, gt, K_other)
        self.parts = {k: float(v.detach()) for k, v in parts.items()}
        self.parts["min_z_fk"] = float(pred["xyz_fk"][..., 2].detach().min())
        return sum(float(cfg[f"{k}_loss_weight"]) * parts[k]
                   for k in LOSS_TERMS)

    def step(self, batch: Mapping, generator: Optional[torch.Generator]
             ) -> float:
        """One step; `self.grads` holds the gradients Adam was given."""
        for p in self.params.values():
            p.grad = None
        loss = self.loss(batch, generator)
        loss.backward()
        with torch.no_grad():
            g = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in self.params.items()}
            norm = torch.sqrt(sum((x.double() ** 2).sum() for x in g.values()))
            clip = float(self.cfg["clip_gradient"] or 0.0)
            scale = min(clip / float(norm), 1.0) if clip else 1.0
            self.grads = {k: x * scale for k, x in g.items()}
            lr = float(self.cfg["lr"]) * schedule_ratio(self.cfg,
                                                        self.t // self.spe)
            self.t += 1
            b1, b2 = self.betas
            c1, c2 = 1.0 - b1 ** self.t, 1.0 - b2 ** self.t
            for k, p in self.params.items():
                gk = self.grads[k]
                self.m[k].mul_(b1).add_(gk, alpha=1.0 - b1)
                self.v[k].mul_(b2).addcmul_(gk, gk, value=1.0 - b2)
                p.sub_(lr / c1 * self.m[k]
                       / (self.v[k].sqrt() / math.sqrt(c2) + self.eps))
        return float(loss.detach())
