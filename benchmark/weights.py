"""Seeded random weights for a FullNet, made on the device in a few calls.

The recipe of the program's `random_state_dict`, copied: He-normal conv
and linear weights (variance 2 / prod(shape[1:])), biases 0.01 N(0, 1),
BatchNorm scales 0.5 + 0.05 N(0, 1), running means 0.1 N(0, 1), running
variances 0.5 + U[0, 1), counters 0. Each kind is one draw from a
`torch.Generator` on the device, cut into the leaves in the order of the
state dict, so the same seed gives the same weights on every run.

Changes make random weights behave as a trained model's would where it
matters to a comparison:
- `depth_layer` predicts about the depths the inputs have: its bias is
  `depth_gamma`, so depth = (gamma + w.f) x k / 1000 m, and its weight is
  x 0.1, so that the root-depth feature moves the depth by some percent
  and no more (unscaled, w.f is as large as gamma and puts roots behind
  the camera; x 1e-3 leaves the hrnet32 branch under float32's rounding,
  where no comparison can see it);
- `scales` multiplies named leaves: serving damps the rotation head's
  output layer (`decrot`) x 0.05, so that its 6-D rotation lies near a
  rotation's, as a trained head's does; a random one puts its two
  3-vectors near parallel, where Gram-Schmidt magnifies rounding
  unevenly from seed to seed. Training damps `decpose` and `decrot`
  x 1e-3: the heads start at the mean joints and the identity rotation,
  as a model that has learnt the data's mean would; random heads swing
  the rotation so far in a step that FK keypoints cross the camera plane,
  where the 2-D keypoint losses are singular;
- `damp_residual` (training) damps each residual branch's last BatchNorm
  scale x 0.1 (torchvision's zero_init_residual damps it the same way),
  without which train-mode BatchNorm amplifies the gradients, and their
  rounding, through the depth of the network.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import torch
from torch import nn

from benchmark.reference.nets import BasicBlock, Bottleneck


def _kind(key: str, value: torch.Tensor) -> str:
    if key.endswith("num_batches_tracked"):
        return "count"
    if key.endswith("running_var"):
        return "var"
    if key.endswith("running_mean"):
        return "mean"
    if value.dim() == 1:
        return "scale" if key.endswith(".weight") else "bias"
    return "he"


def residual_scales(model: nn.Module):
    """Keys of the last BatchNorm scale of every residual branch."""
    for name, m in model.named_modules():
        if isinstance(m, Bottleneck):
            yield f"{name}.bn3.weight"
        elif isinstance(m, BasicBlock):
            yield f"{name}.bn2.weight"


def make_state_dict(model: nn.Module, seed: int, device, depth_gamma: float,
                    scales: Mapping[str, float] = (),
                    damp_residual: bool = False) -> Dict[str, torch.Tensor]:
    """Weights for every entry of `model.state_dict()` (a model on the
    meta device will do: only the keys and shapes are read), on
    `device`, float32."""
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    kinds = {k: _kind(k, torch.empty(s, device="meta"))
             for k, s in shapes.items()}
    g = torch.Generator(device=device).manual_seed(int(seed))
    draws = {}
    for kind, fn, shift, scale in (("he", torch.randn, 0.0, 1.0),
                                   ("bias", torch.randn, 0.0, 0.01),
                                   ("scale", torch.randn, 0.5, 0.05),
                                   ("mean", torch.randn, 0.0, 0.1),
                                   ("var", torch.rand, 0.5, 1.0)):
        n = sum(math.prod(s) for k, s in shapes.items() if kinds[k] == kind)
        draws[kind] = fn(n, generator=g, device=device) * scale + shift
    out, offset = {}, dict.fromkeys(draws, 0)
    for k, s in shapes.items():
        kind = kinds[k]
        if kind == "count":
            out[k] = torch.zeros(s, dtype=torch.int64, device=device)
            continue
        n = math.prod(s)
        leaf = draws[kind][offset[kind]:offset[kind] + n].view(s)
        offset[kind] += n
        if kind == "he":
            leaf = leaf * math.sqrt(2.0 / math.prod(s[1:]))
        out[k] = leaf.clone()
    if damp_residual:
        for k in residual_scales(model):
            out[k] = out[k] * 0.1
    for k, factor in dict(scales).items():
        out[k] = out[k] * factor
    out["depth_layer.weight"] = out["depth_layer.weight"] * 0.1
    out["depth_layer.bias"] = torch.full_like(out["depth_layer.bias"],
                                              float(depth_gamma))
    return out
