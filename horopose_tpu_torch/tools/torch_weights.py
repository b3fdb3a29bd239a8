"""The reference's own torch weight files, read by the port.

Port of what the port needs of `horopose_tpu/tools/torch_weights.py`:

- `load_torch_file`: a `.pth` / `.pk` file's state dict, unwrapping a
  `model_state_dict` entry (the reference's experiment checkpoints), then
  a `state_dict` entry (some ImageNet and CtRNet files);
- `ctrnet_seg_state_dict`: a CtRNet KeyPointSegNet state dict under the
  port's `models/deeplab.py::KeypointSegNet` names (`ctrnet_seg_prefixes`
  is the table of module names);
- `fill_strict`: a model's state dict filled from a source dict, every
  target key present with its shape.

The FullNet, DepthNet (RootNet) and backbone names of the port are the
reference's own, so those files need no name map. Tensors stay torch
tensors: nothing here converts a layout.

CtRNet's names (keypoint_seg_resnet.py): `backbone.0.*` the dilated
ResNet-50, `read_out.kps_score_lowres` the deconv read-out, and the
DeepLabHead under `classifer`. KeyPointSegNet wraps the head in one more
Sequential, so real files nest a level: `classifer.0.0` is the ASPP
(`convs.0` the 1x1 branch, `convs.1-3` the atrous ones, `convs.4` the
pooling branch whose conv and BN sit at `.1` / `.2` behind its pooling,
`project` the projection), `classifer.0.1` / `.0.2` the 3x3 conv and its
BN, `classifer.0.4` the 1x1 classifier. Hand-flattened dumps drop that
level (`classifer.0` the ASPP, `classifer.1/2/4` the tail); both convert.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Tuple

import torch


def load_torch_payload(path: str):
    """What `torch.save` wrote at `path`, its tensors on the CPU. The
    reference's files hold dicts, tensors and numbers only, so the load
    takes no pickled code (`weights_only=True`)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def state_dict_of(payload) -> Dict[str, torch.Tensor]:
    """The tensors of a payload's state dict: its `model_state_dict`
    entry, then its `state_dict` entry, unwrapped where present."""
    for key in ("model_state_dict", "state_dict"):
        if isinstance(payload, Mapping) and key in payload:
            payload = payload[key]
    return {k: v for k, v in payload.items() if isinstance(v, torch.Tensor)}


def load_torch_file(path: str) -> Dict[str, torch.Tensor]:
    """A `.pth` / `.pk` file's state dict (see `state_dict_of`)."""
    return state_dict_of(load_torch_payload(path))


def _seg_head_pairs(head: str) -> Iterable[Tuple[str, str]]:
    """(reference module, port module) of the DeepLab head under
    `head` (`classifer.0` nested, `classifer` flat)."""
    aspp = f"{head}.0"
    for i in range(4):
        for j in range(2):
            yield f"{aspp}.convs.{i}.{j}", f"aspp.branches.{i}.{j}"
    # the pooling branch: AdaptiveAvgPool2d first, then the conv and BN
    yield f"{aspp}.convs.4.1", "aspp.branches.4.0"
    yield f"{aspp}.convs.4.2", "aspp.branches.4.1"
    yield f"{aspp}.project.0", "aspp.project.0"
    yield f"{aspp}.project.1", "aspp.project.1"
    yield f"{head}.1", "cls_conv"
    yield f"{head}.2", "cls_bn"
    yield f"{head}.4", "cls_final"


def ctrnet_seg_prefixes(head: str = "classifer.0"
                        ) -> List[Tuple[str, str]]:
    """(reference key prefix, port key prefix) of every CtRNet module,
    the DeepLab head under `head`."""
    modules = [("backbone.0.", "backbone."),
               ("read_out.kps_score_lowres.", "read_out.")]
    return modules + [(f"{r}.", f"{p}.") for r, p in _seg_head_pairs(head)]


def ctrnet_seg_state_dict(sd: Mapping[str, torch.Tensor]
                          ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """A CtRNet segmentation state dict under the reference's names ->
    (the same tensors under the port's KeypointSegNet names, the source
    keys no name took)."""
    head = ("classifer.0" if "classifer.0.0.convs.0.0.weight" in sd
            else "classifer")
    modules = ctrnet_seg_prefixes(head)
    out, left = {}, []
    for key, value in sd.items():
        for ref, port in modules:
            if key.startswith(ref):
                out[port + key[len(ref):]] = value
                break
        else:
            left.append(key)
    return out, left


def fill_strict(target: Mapping[str, torch.Tensor],
                source: Mapping[str, torch.Tensor],
                optional: Tuple[str, ...] = ()
                ) -> Tuple[Dict[str, torch.Tensor], List[str], List[str]]:
    """The target state dict with every key taken from `source`, in the
    target's dtype: (filled state dict, source keys no target key took,
    target keys left out).

    A target key must be in the source with the same shape, or this
    raises. BatchNorm's `num_batches_tracked`, which old files lack, and
    the keys under an `optional` prefix may be missing: the first is set
    to 0, the others are left out of the result and listed."""
    out, absent, bad = {}, [], []
    for key, ref in target.items():
        value = source.get(key)
        if value is None:
            if key.startswith(optional):
                absent.append(key)
            elif key.endswith("num_batches_tracked"):
                out[key] = torch.zeros_like(ref)
            else:
                bad.append(f"{key}: missing")
            continue
        if tuple(value.shape) != tuple(ref.shape):
            bad.append(f"{key}: {tuple(value.shape)} in the file, "
                       f"{tuple(ref.shape)} in the model")
            continue
        out[key] = value.detach().to(ref.dtype).clone()
    if bad:
        raise ValueError(f"{len(bad)} model tensors cannot be filled from "
                         f"the file, e.g. {'; '.join(bad[:3])}")
    left = [k for k in source if k not in target]
    return out, left, absent
