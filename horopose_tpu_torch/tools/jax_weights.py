"""JAX (flax) variables -> the port's `state_dict`s: FullNet, RootNet, a
standalone backbone, and the sim2real segmentation teacher.

The inverses of `horopose_tpu/tools/torch_weights.py::
convert_fullnet_reference_checkpoint` and `convert_rootnet_reference_
checkpoint`. The port's module names are the reference state-dict keys, so
each flax leaf maps to one torch key:

  conv weight    (kh, kw, I, O) -> (O, I, kh, kw)
  deconv weight  un-flip the taps, then (kh, kw, I, O) -> (I, O, kh, kw)
  linear weight  (I, O)         -> (O, I)
  depth_layer    Dense (I, O)   -> 1x1 conv (O, I, 1, 1) (and offset_layer)
  batchnorm      scale/bias/mean/var -> weight/bias/running_mean/running_var

Inside a flax block the submodules are auto-named in creation order
(`Conv_0..3`, `BatchNorm_0..3`, the downsample conv/bn last), and so is
the RootNet's backbone (`HRNet_0` / `ResNet_0`, the port's `backbone`).
Input is nested dicts of numpy arrays; no JAX is needed. Every flax leaf
must be consumed, or the conversion raises.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from horopose_tpu_torch.models.resnet import RESNET_SPECS

# (kind, torch key prefix, flax path)
_Pair = Tuple[str, str, Tuple[str, ...]]


def _resnet_pairs(stage_sizes, bottleneck: bool, tp: str,
                  fp: Tuple[str, ...]) -> Iterator[_Pair]:
    yield "conv", f"{tp}conv1", fp + ("conv1",)
    yield "bn", f"{tp}bn1", fp + ("bn1",)
    n = 3 if bottleneck else 2
    for stage, n_blocks in enumerate(stage_sizes):
        for i in range(n_blocks):
            yield from _block_pairs(n, f"{tp}layer{stage + 1}.{i}",
                                    fp + (f"layer{stage + 1}_{i}",))


def _block_pairs(n_convs: int, tk: str, fk: Tuple[str, ...]
                 ) -> Iterator[_Pair]:
    for c in range(n_convs):
        yield "conv", f"{tk}.conv{c + 1}", fk + (f"Conv_{c}",)
        yield "bn", f"{tk}.bn{c + 1}", fk + (f"BatchNorm_{c}",)
    yield "conv", f"{tk}.downsample.0", fk + (f"Conv_{n_convs}",)
    yield "bn", f"{tk}.downsample.1", fk + (f"BatchNorm_{n_convs}",)


def _hrnet_pairs(tp: str, fp: Tuple[str, ...]) -> Iterator[_Pair]:
    for name in ("1", "2"):
        yield "conv", f"{tp}conv{name}", fp + (f"conv{name}",)
        yield "bn", f"{tp}bn{name}", fp + (f"bn{name}",)
    for i in range(4):
        yield from _block_pairs(3, f"{tp}layer1.{i}", fp + (f"layer1_{i}",))
    for t, n_new in ((1, 2), (2, 3), (3, 4)):
        for i in range(n_new):
            base, tf = f"{tp}transition{t}.{i}", fp + (f"transition{t}",)
            yield "conv", f"{base}.0", tf + (f"t{i}",)   # channel-adapting
            yield "bn", f"{base}.1", tf + (f"t{i}_bn",)
            for j in range(i + 1):                     # new deeper branch
                yield "conv", f"{base}.{j}.0", tf + (f"t{i}_d{j}",)
                yield "bn", f"{base}.{j}.1", tf + (f"t{i}_d{j}_bn",)
    for snum, n_modules, n_branches in ((2, 1, 2), (3, 4, 3), (4, 3, 4)):
        for m in range(n_modules):
            mk, mf = f"{tp}stage{snum}.{m}", fp + (f"stage{snum}_m{m}",)
            for b in range(n_branches):
                for blk in range(4):
                    tk = f"{mk}.branches.{b}.{blk}"
                    bf = mf + (f"branch{b}_block{blk}",)
                    for c in range(2):
                        yield "conv", f"{tk}.conv{c + 1}", bf + (f"Conv_{c}",)
                        yield "bn", f"{tk}.bn{c + 1}", bf + (f"BatchNorm_{c}",)
            for i in range(n_branches):
                for j in range(n_branches):
                    base, ff = f"{mk}.fuse_layers.{i}.{j}", mf + ("fuse",)
                    if j > i:
                        yield "conv", f"{base}.0", ff + (f"up{i}_{j}",)
                        yield "bn", f"{base}.1", ff + (f"up{i}_{j}_bn",)
                    for k in range(i - j):
                        yield "conv", f"{base}.{k}.0", ff + (f"down{i}_{j}_{k}",)
                        yield "bn", f"{base}.{k}.1", ff + (f"down{i}_{j}_{k}_bn",)
    yield "conv", f"{tp}final_layer", fp + ("final_layer",)
    for i in range(4):
        yield from _block_pairs(3, f"{tp}incre_modules.{i}.0",
                                fp + (f"incre{i}",))
    for i in range(3):
        yield "conv", f"{tp}downsamp_modules.{i}.0", fp + (f"downsamp{i}",)
        yield "bn", f"{tp}downsamp_modules.{i}.1", fp + (f"downsamp{i}_bn",)
    yield "conv", f"{tp}final_feat_layer.0", fp + ("final_feat",)
    yield "bn", f"{tp}final_feat_layer.1", fp + ("final_feat_bn",)


def _backbone_pairs(name: str, tp: str, fp: Tuple[str, ...]
                    ) -> Iterator[_Pair]:
    if name.startswith("hrnet"):
        yield from _hrnet_pairs(tp, fp)
    else:
        block, sizes = RESNET_SPECS[name]
        yield from _resnet_pairs(sizes, block == "bottleneck", tp, fp)


def _fullnet_pairs(backbone_name: str, rootnet_backbone_name: str
                   ) -> Iterator[_Pair]:
    yield from _backbone_pairs(backbone_name, "reg_backbone.",
                               ("reg_backbone",))
    yield from _backbone_pairs(rootnet_backbone_name, "rootnet_backbone.",
                               ("rootnet_backbone",))
    # deconv stack: Sequential indices 0/3/6 are the deconvs, 1/4/7 the BNs
    for i, (ci, bi) in enumerate(((0, 1), (3, 4), (6, 7))):
        yield "deconv", f"deconv_layers.{ci}", (f"deconv{i}",)
        yield "bn", f"deconv_layers.{bi}", (f"deconv{i}_bn",)
    yield "conv", "final_layer", ("final_layer",)
    # reg_joint_map: Sequential indices 0/3/6 are the convs, 1/4/7 the BNs
    for i in range(3):
        yield "conv", f"joint_conv_layers.{3 * i}", (f"joint_conv{i}",)
        yield "bn", f"joint_conv_layers.{3 * i + 1}", (f"joint_conv{i}_bn",)
    yield "conv", "joint_final_layer", ("joint_final_layer",)
    for name in ("fc_pose_1", "fc_pose_2", "decpose", "fc_rot_1", "fc_rot_2",
                 "fc_rot_3", "fc_rot_4", "fc_rot_5", "fc_rot_6", "decrot",
                 "depth_fc_d1", "depth_fc_d2", "depth_fc_u1", "depth_fc_u2"):
        yield "linear", name, (name,)
    yield "bn", "depth_bn", ("depth_bn",)
    yield "dense_as_conv", "depth_layer", ("depth_layer",)


def _get(tree: Mapping, path: Tuple[str, ...]):
    for k in path:
        if not isinstance(tree, Mapping) or k not in tree:
            return None
        tree = tree[k]
    return tree


def _leaf_paths(tree: Mapping, prefix=()) -> Iterator[Tuple[str, ...]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


def _rootnet_pairs(backbone_name: str) -> Iterator[_Pair]:
    sub = "HRNet_0" if backbone_name.startswith("hrnet") else "ResNet_0"
    yield from _backbone_pairs(backbone_name, "backbone.", (sub,))
    for i, (ci, bi) in enumerate(((0, 1), (3, 4), (6, 7))):
        yield "deconv", f"deconv_layers.{ci}", (f"deconv{i}",)
        yield "bn", f"deconv_layers.{bi}", (f"deconv{i}_bn",)
    yield "conv", "xy_layer", ("xy_layer",)
    for i in range(1, 6):
        yield "linear", f"depth_fc{i}", (f"fc{i}",)
        yield "bn", f"depth_bn{i}", (f"fc{i}_bn",)
    yield "dense_as_conv", "depth_layer", ("depth_layer",)
    yield "dense_as_conv", "offset_layer", ("offset_layer",)


def _seg_teacher_pairs() -> Iterator[_Pair]:
    yield from _resnet_pairs((3, 4, 6, 3), True, "backbone.", ("backbone",))
    yield "deconv", "read_out", ("read_out",)
    # ASPP: Conv_0..4 are the 1x1, the three atrous and the pooling
    # branches, Conv_5 the projection (flax numbers each class apart)
    for i in range(6):
        tk = f"aspp.branches.{i}" if i < 5 else "aspp.project"
        yield "conv", f"{tk}.0", ("aspp", f"Conv_{i}")
        yield "bn", f"{tk}.1", ("aspp", f"BatchNorm_{i}")
    yield "conv", "cls_conv", ("cls_conv",)
    yield "bn", "cls_bn", ("cls_bn",)
    yield "conv", "cls_final", ("cls_final",)


def _convert(pairs: Iterator[_Pair], params: Mapping, batch_stats: Mapping):
    """Every pair whose flax module is present -> (its torch tensors,
    float32 CPU; the flax leaves no pair took, as path tuples)."""
    sd: Dict[str, np.ndarray] = {}
    used = set()

    def take(tree, kind, path, leaf):
        used.add((kind,) + path + (leaf,))
        return np.asarray(_get(tree, path)[leaf], np.float32)

    for kind, tk, fp in pairs:
        node = _get(params, fp)
        if node is None:
            continue            # module absent in this configuration
        if kind == "bn":
            sd[f"{tk}.weight"] = take(params, "params", fp, "scale")
            sd[f"{tk}.bias"] = take(params, "params", fp, "bias")
            sd[f"{tk}.running_mean"] = take(batch_stats, "batch_stats", fp,
                                            "mean")
            sd[f"{tk}.running_var"] = take(batch_stats, "batch_stats", fp,
                                           "var")
            continue
        w = take(params, "params", fp, "kernel")
        if kind == "conv":
            w = np.transpose(w, (3, 2, 0, 1))
        elif kind == "deconv":
            w = np.transpose(w[::-1, ::-1], (2, 3, 0, 1))
        elif kind == "linear":
            w = np.transpose(w)
        else:                   # dense_as_conv
            w = np.transpose(w)[:, :, None, None]
        sd[f"{tk}.weight"] = w
        if "bias" in node:
            sd[f"{tk}.bias"] = take(params, "params", fp, "bias")

    left = [("params",) + p for p in _leaf_paths(params)
            if ("params",) + p not in used]
    left += [("batch_stats",) + p for p in _leaf_paths(batch_stats)
             if ("batch_stats",) + p not in used]
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sd.items()}, left


def _state_dict_from_jax(pairs: Iterator[_Pair], params: Mapping,
                         batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """`_convert`, raising if a flax leaf is left over."""
    sd, left = _convert(pairs, params, batch_stats)
    if left:
        raise ValueError(f"{len(left)} JAX leaves have no torch key, e.g. "
                         f"{'/'.join(left[0])}")
    return sd


def fullnet_state_dict_from_jax(params: Mapping, batch_stats: Mapping,
                                backbone_name: str = "resnet50",
                                rootnet_backbone_name: str = "hrnet32"
                                ) -> Dict[str, torch.Tensor]:
    """JAX FullNet `params` / `batch_stats` (nested dicts of arrays) ->
    the port's FullNet state dict (float32 CPU tensors). BatchNorm's
    `num_batches_tracked` has no flax counterpart; `load_state_dict` fills
    it with 0."""
    return _state_dict_from_jax(
        _fullnet_pairs(backbone_name, rootnet_backbone_name), params,
        batch_stats)


def rootnet_state_dict_from_jax(params: Mapping, batch_stats: Mapping,
                                backbone_name: str = "resnet50"
                                ) -> Dict[str, torch.Tensor]:
    """JAX RootNet variables -> the port's RootNet state dict: the
    auto-named `HRNet_0` / `ResNet_0` subtree becomes `backbone.*`, the
    fc bottleneck `fc{i}` / `fc{i}_bn` becomes `depth_fc{i}` /
    `depth_bn{i}`, and the Dense depth and offset heads become 1x1 convs."""
    return _state_dict_from_jax(_rootnet_pairs(backbone_name), params,
                                batch_stats)


def backbone_state_dict_from_jax(params: Mapping, batch_stats: Mapping,
                                 backbone_name: str):
    """A standalone backbone's flax variables (`tools/convert.py`'s
    msgpack: conv1, layer1_0, ... at the top) -> (the backbone's state dict
    under the port's names, the flax leaves no torch key took)."""
    sd, left = _convert(_backbone_pairs(backbone_name, "", ()), params,
                        batch_stats)
    return sd, ["/".join(p) for p in left]


def seg_teacher_state_dict_from_jax(params: Mapping, batch_stats: Mapping
                                    ) -> Dict[str, torch.Tensor]:
    """The JAX KeypointSegNet's variables (`backbone/layer{s}_{i}/Conv_*`,
    `read_out`, `aspp/Conv_*`, `cls_*`) -> the port's KeypointSegNet state
    dict (`models/deeplab.py`): the deconv read-out un-flipped, the ASPP
    branches in creation order."""
    return _state_dict_from_jax(_seg_teacher_pairs(), params, batch_stats)


def state_dict_from_jax(model, params: Mapping, batch_stats: Mapping
                        ) -> Dict[str, torch.Tensor]:
    """The flax variables of the JAX twin of `model` (a FullNet or a
    RootNet of the port) -> `model`'s state dict, the architecture read
    from the model."""
    from horopose_tpu_torch.models.depth_net import RootNet
    from horopose_tpu_torch.models.full_net import FullNet
    if isinstance(model, FullNet):
        return fullnet_state_dict_from_jax(params, batch_stats,
                                           model.backbone_name,
                                           model.rootnet_backbone_name)
    if isinstance(model, RootNet):
        return rootnet_state_dict_from_jax(params, batch_stats,
                                           model.backbone_name)
    raise TypeError(f"no JAX weight map for {type(model).__name__}")
