"""Shared model utilities: training with BatchNorm frozen.

Port of `horopose_tpu/models/common.py::frozen_batchnorm`. The sim2real
stage trains with every BatchNorm normalising by its running statistics,
which it never updates, while dropout stays live and BatchNorm's scale and
bias still train (the reference sets m.eval() on each BN module after
model.train()). The JAX package bakes that in at trace time; here it is
the modules' modes.
"""

from __future__ import annotations

from torch import nn


def train_with_frozen_batchnorm(model: nn.Module) -> nn.Module:
    """`model` in train mode (dropout on) with every BatchNorm module in
    eval mode; returns it."""
    model.train()
    for m in model.modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.eval()
    return model
