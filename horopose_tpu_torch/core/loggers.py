"""Experiment folders, scalar logs, meters.

Port of `horopose_tpu/core/loggers.py`: `create_logger` makes
`<exp_root>/<exp_name>/{ckpt,log}/` and copies the config file beside
them; `ScalarWriter` appends the same `log/scalars.jsonl` records
({tag, value, step, t}). It writes no TensorBoard stream: importing
`torch.utils.tensorboard` loads TensorFlow where that is installed, which
takes seconds, and the JSONL file carries every scalar. The port runs one
process, so every writer is the main process's; `NullWriter` stays for
callers that want none.
`DeviceLogAccumulator` keeps the per-step losses on the device and reads
them on the host once per flush, as the JAX class does.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Dict, List

import torch


class ScalarWriter:
    """Appends one JSON line per scalar to `<log_dir>/scalars.jsonl`."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a",
                           buffering=1, encoding="utf-8")

    def add_scalar(self, tag: str, value, step: int):
        self._jsonl.write(json.dumps(dict(tag=tag, value=float(value),
                                          step=int(step), t=time.time()))
                          + "\n")

    def close(self):
        self._jsonl.close()


class NullWriter:
    """A scalar writer that writes nothing."""

    def add_scalar(self, tag: str, value, step: int):
        pass

    def close(self):
        pass


def create_logger(cfg, exp_root: str = "experiments"):
    """(save_folder, ckpt_folder, log_folder, ScalarWriter) of
    `<exp_root>/<cfg.exp_name>`, with the config file copied to
    `config.yaml` there."""
    save_folder = os.path.join(exp_root, cfg.exp_name)
    ckpt_folder = os.path.join(save_folder, "ckpt")
    log_folder = os.path.join(save_folder, "log")
    os.makedirs(ckpt_folder, exist_ok=True)
    os.makedirs(log_folder, exist_ok=True)
    writer = ScalarWriter(log_folder)
    if cfg.config_path and os.path.exists(cfg.config_path):
        shutil.copy(cfg.config_path, os.path.join(save_folder, "config.yaml"))
    return save_folder, ckpt_folder, log_folder, writer


class AverageMeter:
    """Streaming mean."""

    def __init__(self):
        self.sum = 0.0
        self.n = 0

    def add(self, value, n: int = 1):
        self.sum += float(value) * n
        self.n += n

    @property
    def mean(self) -> float:
        return self.sum / self.n if self.n else 0.0


class DeviceLogAccumulator:
    """Meters fed from device scalars without a host sync per step.

    `push` queues a step's logs (device scalars); every `flush_every`
    pushes, and on `flush()`, the queued values are stacked on the device
    and copied to the host in one transfer. Read `.meters[tag]` or
    `mean(tag)` after a flush."""

    def __init__(self, flush_every: int = 100):
        self.flush_every = int(flush_every)
        self._pending: List[Dict[str, torch.Tensor]] = []
        self.meters: Dict[str, AverageMeter] = {}

    def push(self, logs: Dict[str, torch.Tensor]):
        self._pending.append(dict(logs))
        if len(self._pending) >= self.flush_every:
            self.flush()

    def flush(self):
        if not self._pending:
            return
        tags = list(self._pending[0])
        values = torch.stack([torch.stack([torch.as_tensor(d[t]).float()
                                           for t in tags])
                              for d in self._pending]).cpu()
        for row in values.tolist():
            for tag, v in zip(tags, row):
                self.meters.setdefault(tag, AverageMeter()).add(v)
        self._pending = []

    def mean(self, tag: str) -> float:
        m = self.meters.get(tag)
        return m.mean if m else 0.0
