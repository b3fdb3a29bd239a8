"""Stage-3 self-supervised sim-to-real fine-tuning.

Port of `horopose_tpu/pipelines/train_sim2real.py`: fine-tune the
synth-pretrained FullNet on a real Panda camera set with no pose labels.
The training signal is the agreement between the differentiable silhouette
render of the predicted pose (`ops/rasterizer.py`) and a frozen
segmentation teacher's mask (`models/deeplab.py`), plus the FK <-> integral
3-D alignment term:
  - losses: the mask (mse_mean, bce or 0.001 * mse_sum), soft IoU, the
    filtered log scale ratio, and the alignment, weighted and summed;
  - BatchNorm frozen (`models/common.py`), dropout on;
  - the joints detached in the render, rendered at the teacher's half
    scale with K scaled to match;
  - validation with the PnP pseudo-ground truth of the real set, the
    best-AUC checkpoint per real set with the epoch guard, and each
    epoch's silhouettes of the worst views under `<exp>/track/`.

One FK poses the whole batch's meshes and one rasterizer call renders it.
The soft-argmax kernels (`ops/integral_cuda.py`) run in the forward and
the backward, through the alignment term.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import numpy as np
import torch

from horopose_tpu_torch import constants as C
from horopose_tpu_torch.core.checkpoint import (BestCheckpointKeeper,
                                                TrainState,
                                                load_checkpoint_file,
                                                model_state_dict,
                                                read_flax_msgpack,
                                                restore_state)
from horopose_tpu_torch.core.engine import (_forward, _update,
                                            build_full_eval_step,
                                            make_optimizer, prepare_gt)
from horopose_tpu_torch.core.loggers import DeviceLogAccumulator, create_logger
from horopose_tpu_torch.kinematics.meshes import (build_robot_mesh,
                                                  check_mesh_fidelity)
from horopose_tpu_torch.models.common import train_with_frozen_batchnorm
from horopose_tpu_torch.models.deeplab import SegTeacher
from horopose_tpu_torch.ops.rasterizer import (render_robot_silhouette,
                                               resolve_faces_per_tile)
from horopose_tpu_torch.parallel.prefetch import prefetch_to_device
from horopose_tpu_torch.pipelines.common import (REAL_DS_SHORTS,
                                                 FullNetConfig,
                                                 dataset_crop_hw,
                                                 get_dataloaders,
                                                 make_pnp_fn, make_robot,
                                                 set_seed)
from horopose_tpu_torch.pipelines.train_full import (init_fullnet_state,
                                                     seeded_fullnet,
                                                     validate_full)

S2R_TAGS = ("loss", "loss_mask", "loss_iou", "loss_scale",
            "loss_error3d_align", "cull_overflow")


def load_seg_teacher(cfg, image_hw=(480, 640), device="cuda") -> SegTeacher:
    """The CtRNet teacher of the train set's camera, from
    `models/panda_segmentation/<camera>.pt` (the CtRNet file converted by
    `python -m horopose_tpu_torch.tools.convert ctrnet_seg`), else from
    `<camera>.msgpack` (the JAX package's converted weights, read without
    flax).

    A missing teacher is an error: the teacher's masks are the stage's only
    training signal. `allow_random_teacher: True` opts into a random one
    (debug runs); it also stands in for a camera the train set's name does
    not reveal."""
    ds = cfg.train_ds_names
    camera = next((c for c in REAL_DS_SHORTS if c in ds), None)
    if camera is None:
        if not cfg.get("allow_random_teacher"):
            raise ValueError(
                f"cannot infer the segmentation-teacher camera from "
                f"train_ds_names={ds!r}; sim2real trains only on the real "
                f"Panda camera sets (known cameras: "
                f"{', '.join(REAL_DS_SHORTS)}). Point train_ds_names at one "
                "of them, or set allow_random_teacher: True for a debug run.")
        camera = "azure"        # debug only: no weights are loaded
    folder = os.path.join("models", "panda_segmentation")
    path = os.path.join(folder, f"{camera}.pt")
    jax_path = os.path.join(folder, f"{camera}.msgpack")
    teacher = SegTeacher.init_random(0, image_hw=image_hw)
    if os.path.exists(path):
        teacher.model.load_state_dict(
            torch.load(path, map_location="cpu", weights_only=True))
        print(f"[sim2real] loaded segmentation teacher: {path}")
    elif os.path.exists(jax_path):
        from horopose_tpu_torch.tools.jax_weights import \
            seg_teacher_state_dict_from_jax
        with open(jax_path, "rb") as f:
            variables = read_flax_msgpack(f.read())
        teacher.model.load_state_dict(seg_teacher_state_dict_from_jax(
            variables["params"], variables["batch_stats"]))
        print(f"[sim2real] loaded segmentation teacher: {jax_path}")
    elif cfg.get("allow_random_teacher"):
        print(f"[sim2real] WARNING: no teacher weights at {path} or "
              f"{jax_path}; proceeding with a RANDOM teacher because "
              "allow_random_teacher=True (masks are meaningless)")
    else:
        raise FileNotFoundError(
            f"no segmentation teacher weights at {path} or {jax_path}. "
            f"Convert the CtRNet checkpoint first (python -m "
            f"horopose_tpu_torch.tools.convert ctrnet_seg {camera}.pth "
            f"{path}) or set allow_random_teacher: True to train against a "
            "random teacher (debug only: the self-supervised losses would "
            "be garbage).")
    return teacher.to(device)


def mask_losses(cfg, rendered: torch.Tensor, seg_masks: torch.Tensor):
    """(mask, IoU, scale) losses of rendered silhouettes against the
    teacher's masks, (B, h, w) each."""
    if cfg.mask_loss_func == "mse_mean":
        loss_mask = ((rendered - seg_masks) ** 2).mean()
    elif cfg.mask_loss_func == "bce":
        r = torch.clamp(rendered, 1e-6, 1 - 1e-6)
        loss_mask = -(seg_masks * torch.log(r)
                      + (1 - seg_masks) * torch.log(1 - r)).mean()
    elif cfg.mask_loss_func == "mse_sum":
        loss_mask = 0.001 * ((rendered - seg_masks) ** 2).sum()
    else:
        raise NotImplementedError(cfg.mask_loss_func)
    inter = (seg_masks * rendered).sum((1, 2))
    seg_area = seg_masks.sum((1, 2))
    render_area = rendered.sum((1, 2))
    union = seg_area + render_area - inter
    loss_iou = 1.0 - (inter / torch.clamp(union, min=1e-9)).mean()
    # log scale ratio of the two masks' exclusive areas, only where it is
    # far from 1 (the filter takes no gradient)
    ratio = (seg_area - inter) / torch.clamp(render_area - inter, min=1e-9)
    sr = ratio.detach()
    keep = ((sr > 5.0) | (sr < 0.2)).float()
    loss_scale = (torch.log(torch.clamp(ratio, min=1e-9)).abs() * keep).sum() \
        / (keep.sum() + 1e-9)
    return loss_mask, loss_iou, loss_scale


def build_sim2real_train_step(cfg, model, robot, robot_mesh,
                              seg_teacher: SegTeacher,
                              optimizer: torch.optim.Optimizer,
                              scheduler: torch.optim.lr_scheduler.LRScheduler,
                              image_hw=(480, 640)):
    """Returns step(batch, generator) -> the loss, its four terms and
    `cull_overflow`, as device scalars. `cfg` is a `config.make_cfg`
    config. One step: the teacher's masks of `images_original` (no
    gradient); the forward with BatchNorm frozen and dropout from
    `generator`; the render at the teacher's resolution with K_original
    scaled to it (K[2, 2] = 1), posed by gt_pose under known_joint; the
    losses; backward, clipping and Adam (`core/engine.py::_update`)."""
    out_hw = seg_teacher.out_hw
    render_scale = out_hw[0] / float(image_hw[0])
    ref = int(cfg.reference_keypoint_id)
    faces_per_tile = resolve_faces_per_tile(cfg.get("raster_faces_per_tile"),
                                            robot_mesh.num_faces)
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch, generator: Optional[torch.Generator]):
        train_with_frozen_batchnorm(model)
        gts = prepare_gt(cfg, robot, batch)
        with torch.no_grad():
            seg_masks = seg_teacher(batch["images_original"])
        preds, _ = _forward(cfg, model, robot, batch, gts, generator)
        K_render = batch["K_original"].float() * render_scale
        K_render[:, 2, 2] = 1.0
        rendered, overflow = render_robot_silhouette(
            robot, robot_mesh,
            gts["gt_pose"] if cfg.known_joint else preds["pose"],
            preds["rot"], preds["trans"], K_render, out_hw, root=ref,
            sigma=1.0, faces_per_tile=faces_per_tile, return_overflow=True)
        loss_mask, loss_iou, loss_scale = mask_losses(cfg, rendered,
                                                      seg_masks)
        loss_align = torch.linalg.vector_norm(
            preds["xyz_fk"] - preds["xyz_int"], dim=2).mean()
        loss = (cfg.mask_loss_weight * loss_mask
                + cfg.iou_loss_weight * loss_iou
                + cfg.scale_loss_weight * loss_scale
                + cfg.align_3d_loss_weight * loss_align)
        _update(cfg, loss, params, optimizer, scheduler)
        return {k: v.detach() for k, v in dict(
            loss=loss, loss_mask=loss_mask, loss_iou=loss_iou,
            loss_scale=loss_scale, loss_error3d_align=loss_align,
            cull_overflow=overflow).items()}

    return step


def _worst_view_ids(eval_step, loader, n: int = 20):
    """The hardest samples by FK 3-D keypoint error, for the tracked views:
    every 5th of the 100 worst, at most n."""
    ids, errs = [], []
    for batch in loader:
        preds, gts, _ = eval_step(batch)
        e = torch.linalg.vector_norm(preds["xyz_fk"] - gts["gt_keypoints3d"],
                                     dim=-1).mean(1)
        ids.extend(batch["image_id"].tolist())
        errs.extend(e.tolist())
    order = np.argsort(errs)[::-1]                 # worst first
    return [int(ids[i]) for i in order[:100][::5][:n]]


def _render_tracked_views(cfg, robot, robot_mesh, seg_teacher, eval_step, ds,
                          view_ids, epoch: int, save_folder: str,
                          batch_size: int, device):
    """Rendered-against-teacher silhouettes of the tracked views, one image
    each under `<save_folder>/track/`."""
    from horopose_tpu_torch.core.vis import save_silhouette_comparison
    from horopose_tpu_torch.data.samplers import collate
    from horopose_tpu_torch.parallel.prefetch import to_device
    if not view_ids:
        return
    prev = ds.return_original_image
    ds.return_original_image = True
    try:
        samples = [ds[i] for i in view_ids]
    finally:
        ds.return_original_image = prev
    out_hw = seg_teacher.out_hw
    faces_per_tile = resolve_faces_per_tile(cfg.get("raster_faces_per_tile"),
                                            robot_mesh.num_faces)
    for c0 in range(0, len(samples), batch_size):
        batch = to_device(collate(samples[c0:c0 + batch_size]), device)
        originals = batch.pop("images_original")
        with torch.no_grad():
            preds, _, _ = eval_step(batch)
            masks = seg_teacher(originals)
            K_r = batch["K_original"].float() * (out_hw[0]
                                                 / float(originals.shape[1]))
            K_r[:, 2, 2] = 1.0
            rendered = render_robot_silhouette(
                robot, robot_mesh, preds["pose"], preds["rot"],
                preds["trans"], K_r, out_hw,
                root=int(cfg.reference_keypoint_id),
                faces_per_tile=faces_per_tile)
        for j, vid in enumerate(view_ids[c0:c0 + batch_size]):
            save_silhouette_comparison(
                rendered[j].cpu().numpy(), masks[j].cpu().numpy(),
                os.path.join(save_folder, "track",
                             f"epoch{epoch:03d}_view{vid}.jpg"))


def train_sim2real(cfg, loaders: Optional[Mapping] = None,
                   max_epochs: Optional[int] = None,
                   max_steps_per_epoch: Optional[int] = None,
                   seg_teacher: Optional[SegTeacher] = None, device="cuda",
                   dtype: torch.dtype = torch.float32,
                   exp_root: str = "experiments") -> TrainState:
    """Train stage 3 as the `config.make_cfg` config says, its experiment
    folder under `exp_root`; returns the final TrainState. `loaders`
    defaults to `get_dataloaders(cfg, device)`; the train set's samples
    must carry `images_original`, the full frames the teacher reads."""
    set_seed()
    fcfg = FullNetConfig.from_cfg(cfg)
    save_folder, ckpt_folder, _, writer = create_logger(cfg, exp_root)
    try:
        return _train(cfg, fcfg, loaders, max_epochs, max_steps_per_epoch,
                      seg_teacher, torch.device(device), dtype, exp_root,
                      save_folder, ckpt_folder, writer)
    finally:
        writer.close()


def _eval_loaders(cfg, loaders, device):
    """The test loaders; without any, the train set itself (the real
    camera sets have no train/test split)."""
    if loaders["test"]:
        return loaders["test"]
    from horopose_tpu_torch.data.dream import DreamDataset
    from horopose_tpu_torch.data.samplers import DataLoader
    rootnet_hw, other_hw = dataset_crop_hw(cfg)
    camera = next((c for c in REAL_DS_SHORTS if c in cfg.train_ds_names),
                  "real")
    ds = DreamDataset(cfg.train_ds_names, color_jitter=False,
                      rgb_augmentation=False, occlusion_augmentation=False,
                      rootnet_resize_hw=rootnet_hw, other_resize_hw=other_hw,
                      extend_ratio=cfg.extend_ratio)
    return {camera: DataLoader(ds, batch_size=int(cfg.batch_size),
                               num_workers=cfg.n_dataloader_workers,
                               drop_last=False,
                               pin_memory=device.type == "cuda")}


def _train(cfg, fcfg, loaders, max_epochs, max_steps_per_epoch, seg_teacher,
           device, dtype, exp_root, save_folder, ckpt_folder, writer):
    robot = make_robot(fcfg, device=device)
    robot_mesh = build_robot_mesh(
        robot.model, {n: i for i, n in enumerate(robot.plan.link_names)})
    check_mesh_fidelity(robot_mesh, context="sim2real")
    if loaders is None:
        loaders = get_dataloaders(cfg, device)
        # the teacher reads the full frame
        loaders["train"].dataset.return_original_image = True
    train_loader = loaders["train"]
    test_loaders = _eval_loaders(cfg, loaders, device)
    steps_per_epoch = max(len(train_loader), 1)

    model = init_fullnet_state(fcfg, seeded_fullnet(fcfg, dtype)).to(device)
    optimizer, scheduler = make_optimizer(fcfg, model.parameters(),
                                          steps_per_epoch)
    state = TrainState(model, optimizer, scheduler)
    start_epoch = 0
    if cfg.resume_run:
        # the whole TrainState of an interrupted run; its keeper names the
        # checkpoints per real camera set, the generic name comes first
        ckpt_dir = os.path.join(exp_root, cfg.resume_experiment_name, "ckpt")
        candidates = ["curr_best_auc(add)_model.pk"] + [
            f"curr_best_auc(add)_{c}_model.pk" for c in REAL_DS_SHORTS]
        resume_path = next(
            (os.path.join(ckpt_dir, c) for c in candidates
             if os.path.exists(os.path.join(ckpt_dir, c))),
            os.path.join(ckpt_dir, candidates[0]))
        payload = load_checkpoint_file(resume_path)
        restore_state(state, payload)
        start_epoch = int(payload["epoch"]) + 1
        print(f"[sim2real] resumed {cfg.resume_experiment_name} at epoch "
              f"{start_epoch}")
    elif cfg.pretrained_weight_on_synth:
        # weights only: stage 3 starts a fresh Adam (the stage-2 moments
        # and step count do not carry over)
        payload = load_checkpoint_file(cfg.pretrained_weight_on_synth)
        model.load_state_dict(model_state_dict(payload, model))
        print(f"[sim2real] loaded synth-pretrained weights (weights only) "
              f"from {cfg.pretrained_weight_on_synth}")
    elif not cfg.get("allow_random_init"):
        raise ValueError(
            "sim2real needs pretrained_weight_on_synth (a stage-2 "
            "checkpoint) or resume_run; self-training from random init "
            "produces garbage. Set allow_random_init: True for debug runs.")

    if seg_teacher is None:
        seg_teacher = load_seg_teacher(cfg, device=device)
    keeper = BestCheckpointKeeper(ckpt_folder, fcfg.urdf_robot_name)
    if start_epoch:
        keeper.resume()
    train_step = build_sim2real_train_step(cfg, model, robot, robot_mesh,
                                           seg_teacher, optimizer, scheduler)
    eval_step = build_full_eval_step(fcfg, model, robot,
                                     pnp_fn=make_pnp_fn(cfg.train_ds_names))
    generator = torch.Generator(device=device).manual_seed(C.GLOBAL_SEED)
    ahead = int(cfg.get("prefetch_batches", 2) or 0)

    n_epochs = max_epochs if max_epochs is not None else cfg.n_epochs
    # the tracked worst views, picked once before training
    track_n = int(cfg.get("track_worst_n", 20) or 0)
    tracked = {}
    if track_n > 0 and n_epochs > start_epoch:
        for name, loader in test_loaders.items():
            tracked[name] = _worst_view_ids(
                eval_step, prefetch_to_device(loader, device, ahead), track_n)
            print(f"[sim2real] tracking worst views on {name}: "
                  f"{tracked[name]}")
    for epoch in range(start_epoch, n_epochs):
        # one host read of the logs per 10 steps
        acc = DeviceLogAccumulator(flush_every=10)
        for batchid, batch in enumerate(
                prefetch_to_device(train_loader, device, ahead)):
            if max_steps_per_epoch and batchid >= max_steps_per_epoch:
                break
            acc.push(train_step(batch, generator))
            if (batchid + 1) % 10 == 0:
                acc.flush()
                gstep = epoch * steps_per_epoch + batchid + 1
                for t in S2R_TAGS:
                    writer.add_scalar(f"Train/{t}", acc.mean(t), gstep)
        acc.flush()
        for t in S2R_TAGS:
            writer.add_scalar(f"Train/{t}", acc.mean(t),
                              (epoch + 1) * steps_per_epoch)
        auc_adds = {}
        for name, loader in test_loaders.items():
            auc_adds[name] = validate_full(
                fcfg, robot, eval_step,
                prefetch_to_device(loader, device, ahead), writer, epoch,
                name)
            if tracked.get(name):
                try:
                    _render_tracked_views(
                        cfg, robot, robot_mesh, seg_teacher, eval_step,
                        loader.dataset, tracked[name], epoch, save_folder,
                        int(cfg.batch_size), device)
                except Exception as e:  # a debugging dump never stops training
                    print(f"[sim2real] tracking render failed: {e}")
        keeper.maybe_save(auc_adds, state, epoch)
        print(f"[sim2real] epoch {epoch}: loss={acc.mean('loss'):.4f} "
              f"mask={acc.mean('loss_mask'):.4f} auc={auc_adds}", flush=True)
    return state
