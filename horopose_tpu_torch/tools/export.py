#!/usr/bin/env python
"""CLI: export a trained experiment's serving forward as a `torch.export`
artifact.

Port of `horopose_tpu/tools/export.py`. The exported program is the
Predictor's forward at a fixed batch: uint8 crops in, the documented
outputs out (joint angles, rotation, translation, root depth, the integral
and the FK keypoints, uvd). `ServingModule` is that forward, built from the
same pieces `Predictor.forward` calls (it calls this module), so the two
cannot drift. The soft-argmax runs as the registered operator
`horopose::soft_argmax_3d_fwd` (`ops/integral.py`), which the exported
graph keeps as one node: on a CUDA device the loaded program launches the
hand-written kernel, once a call.

`torch.export.save` writes the graph and the weights into one file, and a
JSON meta (`meta.json`) beside them with the JAX meta's keys, `device` in
place of `platforms`. A program is bound to the device type it was
exported on. Crop and resize stay outside the artifact, as in the JAX
package (`Predictor.preprocess`).

Usage:
  python -m horopose_tpu_torch.tools.export <exp_path> <out.pt2> \\
      [--batch_size 128] [--device cuda] [--bf16] \\
      [--ckpt curr_best_auc\\(add\\)_model.pk]

Serving:
  from horopose_tpu_torch.tools.export import load_serving
  fn, meta = load_serving("model.pt2")
  out = fn(crops_u8, root_crops_u8, k_values, K_crop)   # fixed batch
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Mapping, Optional, Sequence

import torch
from torch import nn

OUTPUTS = ("pose", "rot", "trans", "depth", "xyz_int", "xyz_fk", "uvd")
META_FILE = "meta.json"


class ServingModule(nn.Module):
    """The serving forward: uint8 crops (B, S, S, 3) and root crops
    (B, s, s, 3) divided by 255, the FullNet in eval mode, the FK lift
    `Robot.get_keypoints_root` at the reference keypoint."""

    def __init__(self, model: nn.Module, robot, reference_keypoint_id: int):
        super().__init__()
        self.model = model.eval()
        self.robot = robot
        self.ref = int(reference_keypoint_id)

    def outputs(self, crops: torch.Tensor, crops_root: torch.Tensor,
                k_values: torch.Tensor, K_crops: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        """Every output of the FullNet, and `xyz_fk`."""
        x = (crops.permute(0, 3, 1, 2).float() / 255.0).contiguous()
        xr = (crops_root.permute(0, 3, 1, 2).float() / 255.0).contiguous()
        out = self.model(x, xr, k_values, K_crops)
        out["xyz_fk"] = self.robot.get_keypoints_root(
            out["pose"], out["rot"], out["trans"], root=self.ref)
        return out

    def forward(self, crops, crops_root, k_values, K_crops):
        """The documented outputs, in the order of `OUTPUTS`."""
        out = self.outputs(crops, crops_root, k_values, K_crops)
        return tuple(out[k] for k in OUTPUTS)


def build_serving_module(cfg, state_dict: Optional[Mapping] = None,
                         dtype: Optional[torch.dtype] = None,
                         device="cuda") -> ServingModule:
    """The serving forward of `cfg` (a `FullNetConfig`) on `device`, with
    `state_dict`'s weights (the FullNet's initialisation when None);
    dtype bfloat16 runs the convs under autocast, as the Predictor's."""
    from horopose_tpu_torch.pipelines.common import (build_fullnet,
                                                     make_robot)
    model = build_fullnet(cfg, dtype=dtype or torch.float32)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    model.to(device)
    return ServingModule(model, make_robot(cfg, device=device),
                         cfg.reference_keypoint_id)


def _serving_meta(cfg, robot, batch_size: int, device,
                  dtype: Optional[torch.dtype]) -> dict:
    from horopose_tpu_torch.pipelines.common import crop_sizes
    rootnet, other = crop_sizes(cfg)
    return {
        "batch_size": int(batch_size),
        "other_hw": [other, other],
        "rootnet_hw": [rootnet, rootnet],
        "device": torch.device(device).type,
        "robot": str(cfg.urdf_robot_name),
        "dof": int(robot.dof),
        "num_keypoints": int(robot.num_keypoints),
        "reference_keypoint_id": int(cfg.reference_keypoint_id),
        "compute_dtype": ("bfloat16" if dtype == torch.bfloat16
                          else "float32"),
        "inputs": ["crops_uint8 (B,H,W,3)", "root_crops_uint8 (B,h,w,3)",
                   "k_values (B,)", "K_crop (B,3,3)"],
        "outputs": list(OUTPUTS),
    }


def _example_inputs(meta: Mapping, device) -> tuple:
    """Zero crops, unit k values and identity intrinsics at the meta's
    batch and crop sizes."""
    B = int(meta["batch_size"])
    (H, W), (h, w) = meta["other_hw"], meta["rootnet_hw"]
    u8 = dict(dtype=torch.uint8, device=device)
    return (torch.zeros(B, H, W, 3, **u8), torch.zeros(B, h, w, 3, **u8),
            torch.ones(B, device=device),
            torch.eye(3, device=device).expand(B, 3, 3).contiguous())


def export_module(serving: ServingModule, cfg, out_path: str,
                  batch_size: int = 128, device="cuda",
                  dtype: Optional[torch.dtype] = None) -> dict:
    """`torch.export.export` of `serving` at a fixed batch, saved with
    its weights and meta to `out_path`. Returns the meta."""
    meta = _serving_meta(cfg, serving.robot, batch_size, device, dtype)
    program = torch.export.export(
        serving.eval(), _example_inputs(meta, device), strict=False)
    torch.export.save(program, out_path,
                      extra_files={META_FILE: json.dumps(meta)})
    return meta


def export_serving(cfg, state_dict: Optional[Mapping], out_path: str,
                   batch_size: int = 128, device="cuda",
                   dtype: Optional[torch.dtype] = None) -> dict:
    """Build the serving module of `cfg` with `state_dict` on `device`
    and export it to `out_path` (`export_module`). Returns the meta."""
    serving = build_serving_module(cfg, state_dict, dtype, device)
    return export_module(serving, cfg, out_path, batch_size, device, dtype)


def export_experiment(exp_path: str, out_path: str, batch_size: int = 128,
                      device="cuda", bf16: bool = False,
                      ckpt_name: str = "curr_best_auc(add)_model.pk") -> dict:
    """Load the experiment as `Predictor.from_experiment` does (the port's,
    the JAX package's or the reference's checkpoint), then export its
    serving module. Returns the meta."""
    from horopose_tpu_torch.predictor import Predictor
    dtype = torch.bfloat16 if bf16 else torch.float32
    pred = Predictor.from_experiment(exp_path, ckpt_name=ckpt_name,
                                     device=device, dtype=dtype)
    return export_module(pred.serving, pred.cfg, out_path, batch_size,
                         device, dtype)


def load_serving(path: str, device="cuda"):
    """An artifact -> (callable, meta). The callable takes (crops_u8,
    root_crops_u8, k_values, K_crop) at exactly the exported shapes, on
    the device type it was exported on, and returns {name: tensor}."""
    import horopose_tpu_torch.ops.integral  # noqa: F401 (the operators)
    extra = {META_FILE: ""}
    program = torch.export.load(path, extra_files=extra)
    meta = json.loads(extra[META_FILE])
    if torch.device(device).type != meta["device"]:
        raise ValueError(f"{path} was exported for {meta['device']}, not "
                         f"{torch.device(device).type}")
    module = program.module()

    def fn(crops, crops_root, k_values, K_crop):
        with torch.inference_mode():
            return dict(zip(meta["outputs"],
                            module(crops, crops_root, k_values, K_crop)))

    return fn, meta


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("exp_path")
    p.add_argument("out_path")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--device", default="cuda")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--ckpt", default="curr_best_auc(add)_model.pk")
    args = p.parse_args(argv)
    t0 = time.perf_counter()
    meta = export_experiment(args.exp_path, args.out_path,
                             batch_size=args.batch_size, device=args.device,
                             bf16=args.bf16, ckpt_name=args.ckpt)
    size = os.path.getsize(args.out_path)
    print(f"wrote {args.out_path} ({size / 1e6:.1f} MB) in "
          f"{time.perf_counter() - t0:.1f} s")
    print(json.dumps(meta, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
