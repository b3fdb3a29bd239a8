"""Checkpoints with the best-per-dataset policy.

Port of `horopose_tpu/core/checkpoint.py`: one file per evaluation dataset
(dr, and for panda the four real sets), each written only when its metric
improved and when the file on disk is from an older epoch (the guard
against a restarted run overwriting a newer checkpoint). File names keep
the `curr_best_*_DATASET_model.pk` templates.

The format is the port's own: `torch.save` of {epoch, metric, model,
optimizer, scheduler, ...} (state dicts), written to a temporary file and
renamed. The JAX package writes flax msgpack, which the port cannot read
without flax; reading JAX checkpoints is ROADMAP queue 1 item 4.
"""

from __future__ import annotations

import dataclasses
import os
import zipfile
from typing import Any, Dict, Optional

import torch
from torch import nn

REAL_DATASETS = ("azure", "kinect", "realsense", "orb")


@dataclasses.dataclass
class TrainState:
    """What a checkpoint holds: the model, and the optimizer and scheduler
    when training."""
    model: nn.Module
    optimizer: Optional[torch.optim.Optimizer] = None
    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None


def save_checkpoint_file(path: str, *, epoch: int, metric: float,
                         state: TrainState, extra: Optional[Dict] = None):
    payload = dict(epoch=int(epoch), metric=float(metric),
                   model=state.model.state_dict())
    for name in ("optimizer", "scheduler"):
        part = getattr(state, name)
        if part is not None:
            payload[name] = part.state_dict()
    if extra:
        payload.update(extra)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint_file(path: str) -> Dict[str, Any]:
    """The payload, its tensors on the CPU. A file that `torch.save` did
    not write (such as the JAX package's flax msgpack checkpoints) raises
    NotImplementedError."""
    if not zipfile.is_zipfile(path):
        raise NotImplementedError(
            f"{path} is not a checkpoint of the port (torch.save); reading "
            f"the JAX package's flax msgpack checkpoints is not ported yet "
            f"(ROADMAP queue 1 item 4)")
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_state(state: TrainState, payload: Dict) -> TrainState:
    """Load a payload's model, optimizer and scheduler state into `state`
    in place (strict: every key must match)."""
    state.model.load_state_dict(payload["model"])
    for name in ("optimizer", "scheduler"):
        part = getattr(state, name)
        if part is not None:
            part.load_state_dict(payload[name])
    return state


def checkpoint_epoch(path: str) -> int:
    """Epoch recorded in an existing checkpoint, or -1."""
    if not os.path.exists(path):
        return -1
    try:
        return int(load_checkpoint_file(path)["epoch"])
    except Exception:
        return -1


class BestCheckpointKeeper:
    """Best-by-metric per dataset with the epoch-regression guard; `mode`
    "max" keeps the highest metric (an AUC), "min" the lowest (a depth
    error)."""

    def __init__(self, ckpt_folder: str, robot_type: str,
                 template: str = "curr_best_auc(add)_DATASET_model.pk",
                 mode: str = "max"):
        if mode not in ("max", "min"):
            raise ValueError(f"mode 'max' or 'min', not {mode!r}")
        self.folder = ckpt_folder
        self.robot_type = robot_type
        self.mode = mode
        os.makedirs(ckpt_folder, exist_ok=True)
        self.paths = {"dr": os.path.join(
            ckpt_folder, template.replace("_DATASET", ""))}
        for name in REAL_DATASETS:
            self.paths[name] = os.path.join(
                ckpt_folder, template.replace("DATASET", name))
        init = 0.0 if mode == "max" else float("inf")
        self.best = {k: init for k in self.paths}

    def resume(self) -> Dict[str, float]:
        """The best metrics of the checkpoints already on disk."""
        for name, path in self.paths.items():
            if os.path.exists(path):
                try:
                    self.best[name] = float(
                        load_checkpoint_file(path)["metric"])
                except Exception:
                    pass
        return dict(self.best)

    def maybe_save(self, metrics: Dict[str, float], state: TrainState,
                   epoch: int, lr_last_epoch: int = -1):
        """metrics: {dataset name: metric}. Saves every dataset whose metric
        improved and whose checkpoint on disk is from an older epoch;
        returns their names."""
        saved = []
        names = ["dr"] + (list(REAL_DATASETS)
                          if self.robot_type == "panda" else [])
        for name in names:
            if name not in metrics:
                continue
            if epoch <= checkpoint_epoch(self.paths[name]):
                continue  # guard: never overwrite a newer checkpoint
            improved = (metrics[name] > self.best[name] if self.mode == "max"
                        else metrics[name] < self.best[name])
            if improved:
                self.best[name] = metrics[name]
                save_checkpoint_file(
                    self.paths[name], epoch=epoch, metric=metrics[name],
                    state=state, extra=dict(
                        lr_scheduler_last_epoch=int(lr_last_epoch)))
                saved.append(name)
        return saved
