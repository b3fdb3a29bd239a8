"""Stage-1 DepthNet training.

Port of `horopose_tpu/pipelines/train_depthnet.py`: build the RootNet from
the config, run epochs of train steps, validate each test set (the
`Val/rootz_loss_*` and `Val/mean_depth_error_*` scalars), keep the
lowest-depth-error checkpoint per dataset with the epoch-regression guard,
and resume from an experiment's checkpoint.

The loaders are the DREAM loaders of the config
(`pipelines.common.get_dataloaders`) unless the caller passes its own:
{"train": a sized iterable of batches, "test": {dataset name: an iterable
of batches}}, each batch a dict of tensors in the JAX `DataLoader`'s
layout (`data.samplers.collate`, `data.synthetic.synthetic_dream_batch`).
Batches reach the training device through
`parallel.prefetch.prefetch_to_device`, `cfg.prefetch_batches` ahead; a
batch already there passes through.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import torch

from horopose_tpu_torch import constants as C
from horopose_tpu_torch.core.checkpoint import (BestCheckpointKeeper,
                                                TrainState,
                                                load_checkpoint_file,
                                                restore_state)
from horopose_tpu_torch.core.engine import (build_depthnet_eval_step,
                                            build_depthnet_train_step,
                                            make_optimizer)
from horopose_tpu_torch.core.loggers import (AverageMeter,
                                             DeviceLogAccumulator,
                                             create_logger)
from horopose_tpu_torch.models.depth_net import RootNet
from horopose_tpu_torch.parallel.prefetch import prefetch_to_device
from horopose_tpu_torch.pipelines.common import get_dataloaders

CKPT_TEMPLATE = "curr_best_root_depth(wholistic)_DATASET_model.pk"


def build_rootnet(cfg, dtype: torch.dtype = torch.float32) -> RootNet:
    """The config's RootNet, its weights drawn from a CPU generator seeded
    with GLOBAL_SEED (the global generator is left as it was)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(C.GLOBAL_SEED)
        return RootNet(backbone_name=cfg.backbone_name,
                       pred_xy=bool(cfg.use_rootnet_xy_branch),
                       use_offset=bool(cfg.use_offset),
                       add_fc=bool(cfg.add_fc),
                       input_size=int(cfg.image_size), dtype=dtype)


def train_depthnet(cfg, loaders: Optional[Mapping] = None,
                   max_epochs: Optional[int] = None,
                   max_steps_per_epoch: Optional[int] = None,
                   device="cuda", dtype: torch.dtype = torch.float32,
                   exp_root: str = "experiments") -> TrainState:
    """Train stage 1 as the config says, its experiment folder under
    `exp_root`; returns the final TrainState. `loaders` defaults to
    `get_dataloaders(cfg, device)`."""
    if cfg.get("backbone_pretrained"):
        raise NotImplementedError("backbone_pretrained: loading ImageNet "
                                  "backbone weights is not ported yet "
                                  "(ROADMAP queue 1 item 4)")
    if loaders is None:
        loaders = get_dataloaders(cfg, device)
    _, ckpt_folder, _, writer = create_logger(cfg, exp_root)
    try:
        return _train(cfg, loaders, max_epochs, max_steps_per_epoch, device,
                      dtype, exp_root, ckpt_folder, writer)
    finally:
        writer.close()


def _train(cfg, loaders, max_epochs, max_steps_per_epoch, device, dtype,
           exp_root, ckpt_folder, writer) -> TrainState:
    train_loader = loaders["train"]
    steps_per_epoch = max(len(train_loader), 1)

    model = build_rootnet(cfg, dtype).to(device)
    optimizer, scheduler = make_optimizer(cfg, model.parameters(),
                                          steps_per_epoch)
    state = TrainState(model, optimizer, scheduler)
    keeper = BestCheckpointKeeper(ckpt_folder, cfg.urdf_robot_name,
                                  template=CKPT_TEMPLATE, mode="min")
    start_epoch = 0
    if cfg.resume_run:
        resume_path = os.path.join(exp_root, cfg.resume_experiment_name,
                                   "ckpt",
                                   os.path.basename(keeper.paths["dr"]))
        payload = load_checkpoint_file(resume_path)
        restore_state(state, payload)
        start_epoch = int(payload["epoch"]) + 1
        keeper.resume()

    train_step = build_depthnet_train_step(cfg, model, optimizer, scheduler)
    eval_step = build_depthnet_eval_step(cfg, model)
    ahead = int(cfg.get("prefetch_batches", 2) or 0)

    def validate(name, loader, epoch):
        loss_meter = AverageMeter()
        errors = []
        for batch in prefetch_to_device(loader, device, ahead):
            out = eval_step(batch)
            valid = batch.get("_valid")
            err = out["error_depth"]
            if valid is not None:
                valid = valid.bool()
                err = err[valid]
            # the loss is a masked mean over `_valid`; weighting it by the
            # real rows makes the epoch mean exact too
            loss_meter.add(float(out["loss"]), n=int(valid.sum())
                           if valid is not None else 1)
            errors.append(err)
        mean_err = (float(torch.cat(errors).mean()) if errors
                    else float("inf"))
        writer.add_scalar(f"Val/rootz_loss_{name}", loss_meter.mean, epoch)
        writer.add_scalar(f"Val/mean_depth_error_{name}", mean_err, epoch)
        return mean_err

    n_epochs = max_epochs if max_epochs is not None else cfg.n_epochs
    for epoch in range(start_epoch, n_epochs):
        # one host read per 100 steps, not one per step
        acc = DeviceLogAccumulator(flush_every=100)
        for batchid, batch in enumerate(
                prefetch_to_device(train_loader, device, ahead)):
            if max_steps_per_epoch and batchid >= max_steps_per_epoch:
                break
            acc.push(train_step(batch))
            if (batchid + 1) % 100 == 0:
                acc.flush()
                writer.add_scalar("Train/loss", acc.mean("loss"),
                                  epoch * steps_per_epoch + batchid + 1)
        acc.flush()
        writer.add_scalar("Train/loss_epoch", acc.mean("loss"), epoch)

        depth_errors = {name: validate(name, loader, epoch)
                        for name, loader in loaders["test"].items()}
        keeper.maybe_save(depth_errors, state, epoch)
        print(f"[depthnet] epoch {epoch}: "
              f"train_loss={acc.mean('loss'):.4f} "
              f"depth_errors={depth_errors}", flush=True)
    return state
