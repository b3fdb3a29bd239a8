"""Checkpoints with the best-per-dataset policy.

Port of `horopose_tpu/core/checkpoint.py`: one file per evaluation dataset
(dr, and for panda the four real sets), each written only when its metric
improved and when the file on disk is from an older epoch (the guard
against a restarted run overwriting a newer checkpoint). File names keep
the `curr_best_*_DATASET_model.pk` templates.

The port writes its own format: `torch.save` of {epoch, metric, model,
optimizer, scheduler, ...} (state dicts), to a temporary file renamed into
place. It also reads two other payloads:

- the JAX package's checkpoints, flax msgpack files of {epoch, metric,
  params, batch_stats, opt_state, step, ...}, read with the `msgpack`
  module alone (`read_flax_msgpack`). Their weights go through
  `tools/jax_weights.py` (`model_state_dict`); `restore_state` also
  carries optax's Adam moments, step count and schedule into the port's
  `torch.optim.Adam` and LambdaLR, so a JAX run resumes in the port;
- the reference's `.pk` files, `torch.save` of {epoch, auc_add,
  model_state_dict, optimizer_state_dict, lr_scheduler_last_epoch}, whose
  weights are under the port's names already.
"""

from __future__ import annotations

import dataclasses
import os
import zipfile
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

# flax.serialization's msgpack ext codes
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"

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


def _ndarray(data: bytes) -> np.ndarray:
    import msgpack
    shape, dtype, buf = msgpack.unpackb(data, raw=True)
    dtype = dtype.decode()
    if dtype == "bfloat16":       # numpy has none: widen the bits to f32
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, np.dtype(dtype)).reshape(shape).copy()


def _ext_hook(code: int, data: bytes):
    import msgpack
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_COMPLEX:
        re, im = msgpack.unpackb(data)
        return complex(re, im)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    return msgpack.ExtType(code, data)


def _unchunk(tree):
    """Rebuild the arrays flax splits into {'__msgpack_chunked_array__',
    'shape', 'chunks'} dicts (arrays over 2^30 bytes)."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def read_flax_msgpack(data: bytes) -> Dict[str, Any]:
    """`flax.serialization.msgpack_restore` without flax: nested dicts of
    numpy arrays and scalars."""
    import msgpack
    return _unchunk(msgpack.unpackb(data, ext_hook=_ext_hook, raw=False))


def is_jax_payload(payload: Mapping) -> bool:
    """A JAX checkpoint holds flax `params`; the port's holds `model`."""
    return "params" in payload and "model" not in payload


def is_reference_payload(payload: Mapping) -> bool:
    """A reference checkpoint holds `model_state_dict`."""
    return "model_state_dict" in payload and "model" not in payload


def load_checkpoint_file(path: str) -> Dict[str, Any]:
    """The payload: the port's or the reference's (a zip that `torch.save`
    wrote), its tensors on the CPU, or the JAX package's (flax msgpack),
    its arrays numpy."""
    if zipfile.is_zipfile(path):
        return torch.load(path, map_location="cpu", weights_only=True)
    with open(path, "rb") as f:
        return read_flax_msgpack(f.read())


def model_state_dict(payload: Mapping, model: nn.Module
                     ) -> Dict[str, torch.Tensor]:
    """The payload's weights as `model`'s state dict: the port's `model`
    entry, the reference's `model_state_dict` entry, or a JAX payload's
    `params` and `batch_stats` mapped by
    `tools/jax_weights.state_dict_from_jax`."""
    if is_jax_payload(payload):
        from horopose_tpu_torch.tools.jax_weights import state_dict_from_jax
        return state_dict_from_jax(model, payload["params"],
                                   payload.get("batch_stats") or {})
    if is_reference_payload(payload):
        from horopose_tpu_torch.tools.torch_weights import state_dict_of
        return state_dict_of(payload)
    return payload["model"]


def restore_state(state: TrainState, payload: Dict) -> TrainState:
    """Load a payload's model, optimizer and scheduler state into `state`
    in place (strict: every key must match).

    A JAX payload's optax state goes through `tools/jax_weights.py::
    adam_state_dicts_from_jax` (the Adam moments, the step count, the
    schedule's position). A reference payload restores the model only: its
    optimizer state names parameters by their place in the reference
    model's order, which the port does not share, so with an optimizer to
    restore it raises."""
    state.model.load_state_dict(model_state_dict(payload, state.model))
    if state.optimizer is None:
        return state
    if is_jax_payload(payload):
        from horopose_tpu_torch.tools.jax_weights import \
            adam_state_dicts_from_jax
        opt_sd, sched_sd = adam_state_dicts_from_jax(
            state.model, state.optimizer, state.scheduler,
            payload["opt_state"])
        state.optimizer.load_state_dict(opt_sd)
        if sched_sd is not None:
            state.scheduler.load_state_dict(sched_sd)
        return state
    if is_reference_payload(payload):
        raise ValueError(
            "a reference checkpoint's optimizer state is keyed by the "
            "reference model's parameter order, which the port does not "
            "share; start from its weights instead "
            "(pretrained_weight_on_synth, or Predictor.from_experiment)")
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
