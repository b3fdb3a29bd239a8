"""Stage-2 supervised full-network training.

Port of `horopose_tpu/pipelines/train_full.py`: train FullNet on the
synthetic set, validate each epoch on every test set (dr, photo, the four
real sets) with the full metric battery (ADD and PCK AUCs for both the FK
and the integral keypoints, per-keypoint and per-joint meters, about 40
scalars), keep the best-AUC checkpoint per dataset, and resume from an
experiment's checkpoint. `init_fullnet_state` applies ImageNet backbone
weights and the hand-off from a stage-1 DepthNet checkpoint
(`pretrained_rootnet`), the port's or the JAX package's.

Batches come from the DREAM loaders (`pipelines.common.get_dataloaders`)
unless the caller passes its own, and reach the card through
`parallel.prefetch.prefetch_to_device`, `cfg.prefetch_batches` ahead
(0 = off). The model's weights are drawn from a CPU generator seeded with
GLOBAL_SEED, the dropout masks from a generator on the device seeded with
it; the global generators are left as they were.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from horopose_tpu_torch import constants as C
from horopose_tpu_torch.core.checkpoint import (BestCheckpointKeeper,
                                                TrainState, is_jax_payload,
                                                load_checkpoint_file,
                                                restore_state)
from horopose_tpu_torch.core.engine import (build_full_eval_step,
                                            build_full_train_step,
                                            make_optimizer)
from horopose_tpu_torch.core.loggers import (AverageMeter,
                                             DeviceLogAccumulator,
                                             create_logger)
from horopose_tpu_torch.core.metrics import (ADD_THRESHOLDS_MM,
                                             PCK_THRESHOLDS_PX,
                                             compute_metrics_batch,
                                             summary_add_pck)
from horopose_tpu_torch.parallel.prefetch import prefetch_to_device
from horopose_tpu_torch.pipelines.common import (FullNetConfig,
                                                 apply_pretrained_backbone,
                                                 build_fullnet,
                                                 get_dataloaders,
                                                 make_pnp_fn, make_robot,
                                                 set_seed)
from horopose_tpu_torch.tools.jax_weights import rootnet_state_dict_from_jax

# (stage-1 RootNet prefix, stage-2 FullNet prefix)
HANDOFF = (("backbone", "rootnet_backbone"), ("depth_layer", "depth_layer"))

LOSS_TAGS = ["loss_joint", "loss_rot", "loss_trans", "loss_uv", "loss_depth",
             "loss_error2d", "loss_error3d", "loss_error2d_int",
             "loss_error3d_int", "loss_error3d_align"]


def init_fullnet_state(cfg, model: nn.Module) -> nn.Module:
    """Apply the config's pretrained weights to `model` (a FullNet) in
    place, in the JAX package's order: ImageNet weights for either backbone
    (`backbone_pretrained`, `rootnet_backbone_pretrained`, through
    `apply_pretrained_backbone`), then a `pretrained_rootnet` DepthNet
    checkpoint, the port's or the JAX package's, whose `backbone.*` and
    `depth_layer.*` tensors, parameters and BatchNorm buffers alike,
    replace FullNet's `rootnet_backbone.*` and `depth_layer.*`. The two
    backbones must be the same architecture: every key must have its
    counterpart of the same shape, or this raises. Prints the copied
    pairs."""
    for key, name, dst in (
            ("backbone_pretrained", "backbone_name", "reg_backbone"),
            ("rootnet_backbone_pretrained", "rootnet_backbone_name",
             "rootnet_backbone")):
        if getattr(cfg, key, None):
            apply_pretrained_backbone(model, getattr(cfg, key),
                                      getattr(cfg, name), dst,
                                      tag="/train_full")
    path = getattr(cfg, "pretrained_rootnet", None)
    if not path:
        return model
    pre = load_checkpoint_file(path)
    target = model.state_dict()
    if is_jax_payload(pre):
        # the JAX DepthNet's auto-named backbone becomes backbone.*; flax
        # counts no BatchNorm batches, so those counters start at 0
        pre = rootnet_state_dict_from_jax(pre["params"],
                                          pre.get("batch_stats") or {},
                                          cfg.rootnet_backbone_name)
        for k, v in target.items():
            if (k.startswith("rootnet_backbone.")
                    and k.endswith("num_batches_tracked")):
                pre["backbone" + k[len("rootnet_backbone"):]] = \
                    torch.zeros_like(v)
    else:
        pre = pre["model"]
    copied = []
    for src, dst in HANDOFF:
        src_keys = {k for k in pre if k.startswith(src + ".")}
        if not src_keys:
            continue
        dst_keys = [k for k in target if k.startswith(dst + ".")]
        want = {src + k[len(dst):]: k for k in dst_keys}
        if set(want) != src_keys:
            diff = sorted(set(want) ^ src_keys)
            raise ValueError(f"{path}: {src}.* does not match the model's "
                             f"{dst}.* ({len(diff)} keys differ, e.g. "
                             f"{diff[0]})")
        for s, d in want.items():
            if pre[s].shape != target[d].shape:
                raise ValueError(f"{path}: {s} {tuple(pre[s].shape)} does "
                                 f"not fit {d} {tuple(target[d].shape)}")
            target[d] = pre[s]
        copied.append(f"{src}->{dst}")
    model.load_state_dict(target)
    print(f"[train_full] loaded pretrained rootnet: {copied}")
    return model


def seeded_fullnet(cfg: FullNetConfig,
                   dtype: torch.dtype = torch.float32) -> nn.Module:
    """The config's FullNet, its weights drawn from a CPU generator seeded
    with GLOBAL_SEED (the global generator is left as it was)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(C.GLOBAL_SEED)
        return build_fullnet(cfg, dtype=dtype)


def host_numpy(x: torch.Tensor) -> np.ndarray:
    """A float32 numpy copy of a tensor, for the host-side metrics."""
    return x.detach().float().cpu().numpy()


def validate_full(cfg, robot, eval_step, loader, writer, epoch: int,
                  dsname: str) -> float:
    """Validation with the full metric battery; returns the ADD AUC.

    `loader` yields batches on the eval step's device; every batch weighs
    the same in the loss meters, the final partial one too (the
    reference's equal-batch weighting), and the metrics see every row."""
    ds = "_" + dsname
    meters = {t: AverageMeter() for t in ["loss", "rotation_diff"] + LOSS_TAGS}
    alldis = defaultdict(list)
    alldis_int = defaultdict(list)
    nk = robot.num_keypoints
    dof = robot.dof
    kp3 = [AverageMeter() for _ in range(nk)]
    kp2 = [AverageMeter() for _ in range(nk)]
    kp3i = [AverageMeter() for _ in range(nk)]
    kp2i = [AverageMeter() for _ in range(nk)]
    jl1 = [AverageMeter() for _ in range(dof)]

    for batch in loader:
        preds, gts, logs = eval_step(batch)
        for t in meters:
            meters[t].add(float(logs[t]))
        K_orig = host_numpy(batch["K_original"])
        kp2d_orig = host_numpy(batch["keypoints_2d_original"])
        gt_kp3d = host_numpy(gts["gt_keypoints3d"])
        gt_joint = host_numpy(gts["gt_pose_before_mask"])
        m_fk = compute_metrics_batch(
            robot=robot, gt_keypoints3d=gt_kp3d, gt_keypoints2d=kp2d_orig,
            K_original=K_orig, gt_joint=gt_joint,
            pred_keypoints3d=host_numpy(preds["xyz_fk"]),
            pred_joint=host_numpy(preds["pose"]),
            reference_keypoint_id=int(cfg.reference_keypoint_id))
        m_int = compute_metrics_batch(
            robot=robot, gt_keypoints3d=gt_kp3d, gt_keypoints2d=kp2d_orig,
            K_original=K_orig, gt_joint=gt_joint,
            pred_keypoints3d=host_numpy(preds["xyz_int"]), pred_joint=None,
            reference_keypoint_id=int(cfg.reference_keypoint_id))
        alldis["dis3d"].extend(m_fk["image_dis3d_avg"])
        alldis["dis2d"].extend(m_fk["image_dis2d_avg"])
        alldis["jointerror"].extend(m_fk["image_l1jointerror_avg"])
        alldis_int["dis3d"].extend(m_int["image_dis3d_avg"])
        alldis_int["dis2d"].extend(m_int["image_dis2d_avg"])
        for i in range(nk):
            kp3[i].add(m_fk["batch_dis3d_avg"][i])
            kp2[i].add(m_fk["batch_dis2d_avg"][i])
            kp3i[i].add(m_int["batch_dis3d_avg"][i])
            kp2i[i].add(m_int["batch_dis2d_avg"][i])
        for i in range(dof):
            jl1[i].add(m_fk["batch_l1jointerror_avg"][i])

    summary = summary_add_pck(alldis)
    summary_int = summary_add_pck(alldis_int)
    mean_joint_error = float(np.mean(alldis["jointerror"]) / np.pi * 180.0)

    writer.add_scalar("Val/loss" + ds, meters["loss"].mean, epoch)
    writer.add_scalar("Val/pose_loss" + ds, meters["loss_joint"].mean, epoch)
    writer.add_scalar("Val/rot_loss" + ds, meters["loss_rot"].mean, epoch)
    writer.add_scalar("Val/rot_diff" + ds, meters["rotation_diff"].mean, epoch)
    writer.add_scalar("Val/trans_loss" + ds, meters["loss_trans"].mean, epoch)
    writer.add_scalar("Val/uv_loss" + ds, meters["loss_uv"].mean, epoch)
    writer.add_scalar("Val/depth_loss" + ds, meters["loss_depth"].mean, epoch)
    writer.add_scalar("Val/error2d_loss" + ds, meters["loss_error2d"].mean,
                      epoch)
    writer.add_scalar("Val/error3d_loss" + ds, meters["loss_error3d"].mean,
                      epoch)
    writer.add_scalar("Val/error3d_align_loss" + ds,
                      meters["loss_error3d_align"].mean, epoch)
    writer.add_scalar("Val/mean_joint_error" + ds, mean_joint_error, epoch)
    writer.add_scalar("Val/AUC_ADD" + ds, summary["ADD/AUC"], epoch)
    writer.add_scalar("Val/AUC_PCK" + ds, summary["PCK/AUC"], epoch)
    writer.add_scalar("Val/AUC_ADD_integral_xyz_metrics" + ds,
                      summary_int["ADD/AUC"], epoch)
    writer.add_scalar("Val/AUC_PCK_integral_xyz_metrics" + ds,
                      summary_int["PCK/AUC"], epoch)
    for th in ADD_THRESHOLDS_MM:
        writer.add_scalar(f"Val/ADD_{th}_mm" + ds, summary[f"ADD_{th}_mm"],
                          epoch)
    for th in PCK_THRESHOLDS_PX:
        writer.add_scalar(f"Val/PCK_{th}_pixel" + ds,
                          summary[f"PCK_{th}_pixel"], epoch)
    for i in range(nk):
        writer.add_scalar(f"Val/distance3D_keypoint_{i + 1}" + ds,
                          kp3[i].mean, epoch)
        writer.add_scalar(f"Val/distance2D_keypoint_{i + 1}" + ds,
                          kp2[i].mean, epoch)
    for i in range(dof):
        writer.add_scalar(f"Val/l1error_joint_{i + 1}" + ds, jl1[i].mean,
                          epoch)
    return summary["ADD/AUC"]


def train_full(cfg, loaders: Optional[Mapping] = None,
               max_epochs: Optional[int] = None,
               max_steps_per_epoch: Optional[int] = None,
               device="cuda", dtype: torch.dtype = torch.float32,
               exp_root: str = "experiments") -> TrainState:
    """Train stage 2 as the `config.make_cfg` config says, its experiment
    folder under `exp_root`; returns the final TrainState. `loaders`
    ({"train": loader, "test": {name: loader}}, batches of CPU tensors in
    the `data.samplers.collate` layout) defaults to
    `get_dataloaders(cfg, device)`."""
    set_seed()
    fcfg = FullNetConfig.from_cfg(cfg)
    if loaders is None:
        loaders = get_dataloaders(cfg, device)
    _, ckpt_folder, _, writer = create_logger(cfg, exp_root)
    try:
        return _train(cfg, fcfg, loaders, max_epochs, max_steps_per_epoch,
                      torch.device(device), dtype, exp_root, ckpt_folder,
                      writer)
    finally:
        writer.close()


def _train(cfg, fcfg, loaders, max_epochs, max_steps_per_epoch, device,
           dtype, exp_root, ckpt_folder, writer) -> TrainState:
    robot = make_robot(fcfg, device=device)
    train_loader = loaders["train"]
    steps_per_epoch = max(len(train_loader), 1)

    model = init_fullnet_state(fcfg, seeded_fullnet(fcfg, dtype)).to(device)
    optimizer, scheduler = make_optimizer(fcfg, model.parameters(),
                                          steps_per_epoch)
    state = TrainState(model, optimizer, scheduler)
    keeper = BestCheckpointKeeper(ckpt_folder, fcfg.urdf_robot_name)
    start_epoch = 0
    if cfg.resume_run:
        resume_path = os.path.join(exp_root, cfg.resume_experiment_name,
                                   "ckpt", os.path.basename(keeper.paths["dr"]))
        payload = load_checkpoint_file(resume_path)
        restore_state(state, payload)
        start_epoch = int(payload["epoch"]) + 1
        keeper.resume()

    # the reference keys the train and validation pseudo-ground truth on
    # the TRAIN set's name
    pnp_fn = make_pnp_fn(cfg.train_ds_names)
    train_step = build_full_train_step(fcfg, model, robot, optimizer,
                                       scheduler, pnp_fn=pnp_fn)
    eval_step = build_full_eval_step(fcfg, model, robot, pnp_fn=pnp_fn)
    generator = torch.Generator(device=device).manual_seed(C.GLOBAL_SEED)
    ahead = int(cfg.get("prefetch_batches", 2) or 0)

    n_epochs = max_epochs if max_epochs is not None else cfg.n_epochs
    for epoch in range(start_epoch, n_epochs):
        # one host read of the losses per 100 steps, not one per step
        acc = DeviceLogAccumulator(flush_every=100)
        for batchid, batch in enumerate(
                prefetch_to_device(train_loader, device, ahead)):
            if max_steps_per_epoch and batchid >= max_steps_per_epoch:
                break
            acc.push(train_step(batch, generator))
            if (batchid + 1) % 100 == 0:
                acc.flush()
                gstep = epoch * steps_per_epoch + batchid + 1
                writer.add_scalar("Train/loss", acc.mean("loss"), gstep)
                for t in LOSS_TAGS:
                    writer.add_scalar(f"Train/{t}", acc.mean(t), gstep)
        acc.flush()
        writer.add_scalar("Train/loss_epoch", acc.mean("loss"), epoch)

        auc_adds = {name: validate_full(
            fcfg, robot, eval_step, prefetch_to_device(loader, device, ahead),
            writer, epoch, name) for name, loader in loaders["test"].items()}
        keeper.maybe_save(auc_adds, state, epoch)
        print(f"[train_full] epoch {epoch}: loss={acc.mean('loss'):.4f} "
              f"auc_add={auc_adds}", flush=True)
    return state
