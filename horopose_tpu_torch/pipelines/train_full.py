"""Stage 2's start from stage 1: the DepthNet hand-off into FullNet.

Port of the `pretrained_rootnet` branch of
`horopose_tpu/pipelines/train_full.py::init_fullnet_state` (:66-91). The
rest of that pipeline (the epoch loop, the validation battery, the
best-AUC checkpoints) is ROADMAP queue 1 item 3.
"""

from __future__ import annotations

from torch import nn

from horopose_tpu_torch.core.checkpoint import load_checkpoint_file

# (stage-1 RootNet prefix, stage-2 FullNet prefix)
HANDOFF = (("backbone", "rootnet_backbone"), ("depth_layer", "depth_layer"))


def init_fullnet_state(cfg, model: nn.Module) -> nn.Module:
    """Apply the config's stage-1 checkpoint to `model` (a FullNet) in
    place: a `pretrained_rootnet` DepthNet checkpoint's `backbone.*` and
    `depth_layer.*` tensors, parameters and BatchNorm buffers alike, replace
    FullNet's `rootnet_backbone.*` and `depth_layer.*`. The two backbones
    must be the same architecture: every key must have its counterpart of
    the same shape, or this raises. Prints the copied pairs."""
    for key in ("backbone_pretrained", "rootnet_backbone_pretrained"):
        if getattr(cfg, key, None):
            raise NotImplementedError(f"{key}: loading ImageNet backbone "
                                      f"weights is not ported yet (ROADMAP "
                                      f"queue 1 item 4)")
    path = getattr(cfg, "pretrained_rootnet", None)
    if not path:
        return model
    pre = load_checkpoint_file(path)["model"]
    target = model.state_dict()
    copied = []
    for src, dst in HANDOFF:
        src_keys = {k for k in pre if k.startswith(src + ".")}
        if not src_keys:
            continue
        dst_keys = [k for k in target if k.startswith(dst + ".")]
        want = {src + k[len(dst):]: k for k in dst_keys}
        if set(want) != src_keys:
            diff = sorted(set(want) ^ src_keys)
            raise ValueError(f"{path}: {src}.* does not match the model's "
                             f"{dst}.* ({len(diff)} keys differ, e.g. "
                             f"{diff[0]})")
        for s, d in want.items():
            if pre[s].shape != target[d].shape:
                raise ValueError(f"{path}: {s} {tuple(pre[s].shape)} does "
                                 f"not fit {d} {tuple(target[d].shape)}")
            target[d] = pre[s]
        copied.append(f"{src}->{dst}")
    model.load_state_dict(target)
    print(f"[train_full] loaded pretrained rootnet: {copied}")
    return model
