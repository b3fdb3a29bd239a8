#!/usr/bin/env python
"""CLI: the reference's torch weight files -> files the port's loaders read.

Port of `horopose_tpu/tools/convert.py`, with its kinds and flags. Each
kind builds the port's model on the CPU and fills every one of its
tensors from the file, with the same shape (`tools/torch_weights.py::
fill_strict`); the file's tensors that nothing took are listed. It writes:

  fullnet, depthnet   a port checkpoint (`core/checkpoint.py::
                      save_checkpoint_file`, the payload the trainers
                      write), which `Predictor.from_experiment`,
                      `pretrained_weight_on_synth` and `pretrained_rootnet`
                      read; the source's epoch and metric are kept;
  resnet18/34/50,     the backbone's state dict, which `backbone_pretrained`
  hrnet32             and `rootnet_backbone_pretrained` read
                      (`pipelines/common.py::apply_pretrained_backbone`).
                      An ImageNet HRNet file may lack the pose head and the
                      feature head (the reference loads it with
                      strict=False): those are left out and listed;
  ctrnet_seg          the KeypointSegNet state dict under the port's names,
                      which the stage-3 teacher loader reads from
                      `models/panda_segmentation/<camera>.pt`.

Usage:
  python -m horopose_tpu_torch.tools.convert ctrnet_seg azure.pth \\
      models/panda_segmentation/azure.pt
  python -m horopose_tpu_torch.tools.convert fullnet \\
      curr_best_auc\\(add\\)_model.pk out.pk \\
      --backbone resnet50 --rootnet_backbone hrnet32
  python -m horopose_tpu_torch.tools.convert resnet50 resnet50-imagenet.pth \\
      resnet50.pth
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional, Sequence

import torch

from horopose_tpu_torch.tools.torch_weights import (ctrnet_seg_state_dict,
                                                    fill_strict,
                                                    load_torch_payload,
                                                    state_dict_of)

KINDS = ("resnet18", "resnet34", "resnet50", "hrnet32", "ctrnet_seg",
         "fullnet", "depthnet")
# the heads an ImageNet HRNet file may not have
HRNET_HEADS = ("final_layer.", "incre_modules.", "downsamp_modules.",
               "final_feat_layer.")


def build_target(kind: str, backbone: str = "resnet50",
                 rootnet_backbone: str = "hrnet32", image_size: int = 256,
                 pred_xy: bool = False, use_offset: bool = False,
                 add_fc: bool = False) -> torch.nn.Module:
    """The port's model that a file of `kind` fills, on the CPU."""
    if kind.startswith("resnet"):
        from horopose_tpu_torch.models.resnet import get_resnet
        return get_resnet(kind)
    if kind == "hrnet32":
        from horopose_tpu_torch.models.hrnet import get_hrnet
        return get_hrnet(32)
    if kind == "ctrnet_seg":
        from horopose_tpu_torch.models.deeplab import KeypointSegNet
        return KeypointSegNet()
    if kind == "depthnet":
        from horopose_tpu_torch.models.depth_net import RootNet
        return RootNet(backbone_name=backbone, pred_xy=pred_xy,
                       use_offset=use_offset, add_fc=add_fc,
                       input_size=image_size)
    if kind == "fullnet":
        from horopose_tpu_torch.pipelines.common import (FullNetConfig,
                                                         build_fullnet)
        return build_fullnet(FullNetConfig(
            backbone_name=backbone, rootnet_backbone_name=rootnet_backbone,
            image_size=int(image_size)))
    raise ValueError(f"kind one of {KINDS}, not {kind!r}")


def convert_state_dict(kind: str, sd: Dict[str, torch.Tensor],
                       model: torch.nn.Module):
    """A reference state dict -> (`model`'s state dict filled from it, the
    source keys nothing took, the optional target keys left out)."""
    left = []
    if kind == "ctrnet_seg":
        sd, left = ctrnet_seg_state_dict(sd)
    optional = HRNET_HEADS if kind == "hrnet32" else ()
    out, unused, absent = fill_strict(model.state_dict(), sd, optional)
    return out, left + unused, absent


def convert(kind: str, src: str, dst: str, **model_args) -> dict:
    """Convert the file `src` of `kind` into `dst` (see the module's
    docstring); returns what was read, written and left."""
    payload = load_torch_payload(src)
    sd = state_dict_of(payload)
    model = build_target(kind, **model_args)
    out, left, absent = convert_state_dict(kind, sd, model)
    if kind in ("fullnet", "depthnet"):
        from horopose_tpu_torch.core.checkpoint import (TrainState,
                                                        save_checkpoint_file)
        model.load_state_dict(out)
        # the reference keeps its epoch and its best metric (ADD AUC, or
        # the depth error of a DepthNet) beside the weights
        meta = payload if isinstance(payload, dict) else {}
        metric = meta.get("auc_add", meta.get("loss", 0.0))
        save_checkpoint_file(dst, epoch=int(meta.get("epoch", 0)),
                             metric=float(metric),
                             state=TrainState(model),
                             extra=dict(converted_from=str(src)))
    else:
        torch.save(out, dst)
    return dict(read=len(sd), written=len(out), left=left, absent=absent)


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("kind", choices=KINDS)
    p.add_argument("src", help=".pth / .pk torch file")
    p.add_argument("dst", help="output path")
    p.add_argument("--backbone", default="resnet50")
    p.add_argument("--rootnet_backbone", default="hrnet32")
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--pred_xy", action="store_true")
    p.add_argument("--use_offset", action="store_true")
    p.add_argument("--add_fc", action="store_true")
    args = p.parse_args(argv)
    report = convert(args.kind, args.src, args.dst, backbone=args.backbone,
                     rootnet_backbone=args.rootnet_backbone,
                     image_size=args.image_size, pred_xy=args.pred_xy,
                     use_offset=args.use_offset, add_fc=args.add_fc)
    print(f"loaded {report['read']} tensors from {args.src}")
    for key in report["left"]:
        print(f"  not taken: {key}")
    for key in report["absent"]:
        print(f"  not in the file, left out: {key}")
    print(f"converted {report['written']} tensors -> {args.dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
