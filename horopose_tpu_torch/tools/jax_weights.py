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
must be consumed, or the conversion raises. The same pairs and layout
maps carry optax's Adam moments, trees of the params' shape
(`params_like_from_jax`), into `torch.optim.Adam` when the port resumes a
JAX run (`core/checkpoint.py::restore_state`).
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Optional, Tuple

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


def _param_leaves(pairs: Iterator[_Pair], params: Mapping, used: set
                  ) -> Iterator[Tuple[str, np.ndarray]]:
    """(torch key, array) of every trainable flax leaf of the pairs whose
    module is present in `params`, in the torch layout: the weights, the
    biases and the BatchNorm scales and offsets. `params` may be the
    parameters or any tree of their shape (Adam's moments)."""
    def take(path, leaf):
        used.add(("params",) + path + (leaf,))
        return np.asarray(_get(params, path)[leaf], np.float32)

    for kind, tk, fp in pairs:
        node = _get(params, fp)
        if node is None:
            continue            # module absent in this configuration
        if kind == "bn":
            yield f"{tk}.weight", take(fp, "scale")
            yield f"{tk}.bias", take(fp, "bias")
            continue
        w = take(fp, "kernel")
        if kind == "conv":
            w = np.transpose(w, (3, 2, 0, 1))
        elif kind == "deconv":
            w = np.transpose(w[::-1, ::-1], (2, 3, 0, 1))
        elif kind == "linear":
            w = np.transpose(w)
        else:                   # dense_as_conv
            w = np.transpose(w)[:, :, None, None]
        yield f"{tk}.weight", w
        if "bias" in node:
            yield f"{tk}.bias", take(fp, "bias")


def _tensors(sd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Tensors of their own (a JAX array's numpy view is read-only)."""
    return {k: torch.from_numpy(np.array(v, order="C"))
            for k, v in sd.items()}


def _convert(pairs: Iterator[_Pair], params: Mapping, batch_stats: Mapping):
    """Every pair whose flax module is present -> (its torch tensors,
    float32 CPU; the flax leaves no pair took, as path tuples)."""
    pairs = list(pairs)
    used = set()
    sd = dict(_param_leaves(pairs, params, used))
    for kind, tk, fp in pairs:
        if kind != "bn" or _get(params, fp) is None:
            continue
        for torch_name, flax_name in (("running_mean", "mean"),
                                      ("running_var", "var")):
            used.add(("batch_stats",) + fp + (flax_name,))
            sd[f"{tk}.{torch_name}"] = np.asarray(
                _get(batch_stats, fp)[flax_name], np.float32)
    left = [("params",) + p for p in _leaf_paths(params)
            if ("params",) + p not in used]
    left += [("batch_stats",) + p for p in _leaf_paths(batch_stats)
             if ("batch_stats",) + p not in used]
    return _tensors(sd), left


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


def _model_pairs(model) -> Iterator[_Pair]:
    """The pairs of the JAX twin of `model` (a FullNet or a RootNet of the
    port), the architecture read from the model."""
    from horopose_tpu_torch.models.depth_net import RootNet
    from horopose_tpu_torch.models.full_net import FullNet
    if isinstance(model, FullNet):
        return _fullnet_pairs(model.backbone_name,
                              model.rootnet_backbone_name)
    if isinstance(model, RootNet):
        return _rootnet_pairs(model.backbone_name)
    raise TypeError(f"no JAX weight map for {type(model).__name__}")


def state_dict_from_jax(model, params: Mapping, batch_stats: Mapping
                        ) -> Dict[str, torch.Tensor]:
    """The flax variables of the JAX twin of `model` (a FullNet or a
    RootNet of the port) -> `model`'s state dict."""
    return _state_dict_from_jax(_model_pairs(model), params, batch_stats)


def params_like_from_jax(model, tree: Mapping) -> Dict[str, torch.Tensor]:
    """A tree of the JAX twin's `params` shape (optax's Adam moments `mu`
    and `nu`) -> {name of `model`'s parameter: tensor}, through the same
    pairs and layout maps as the weights; BatchNorm has no statistics
    here. Raises if a leaf is left over."""
    used = set()
    sd = dict(_param_leaves(_model_pairs(model), tree, used))
    left = [p for p in _leaf_paths(tree) if ("params",) + p not in used]
    if left:
        raise ValueError(f"{len(left)} JAX leaves have no torch parameter, "
                         f"e.g. {'/'.join(left[0])}")
    return _tensors(sd)


def _adam_in_chain(opt_state: Mapping) -> Tuple[Mapping, Optional[Mapping]]:
    """(adam's state {count, mu, nu}, the state {count} of the learning
    rate schedule right after it, or None) in a serialized optax state.
    The chain is a tuple, {"0": ..., "1": ...}, and adam's place in it
    depends on the config (clipping and weight decay come first when
    set), so it is found by structure."""
    found = []

    def walk(node: Mapping):
        keys = sorted(node, key=lambda k: (not k.isdigit(),
                                           int(k) if k.isdigit() else 0, k))
        for i, k in enumerate(keys):
            child = node[k]
            if not isinstance(child, Mapping):
                continue
            if {"count", "mu", "nu"} <= set(child):
                after = node[keys[i + 1]] if i + 1 < len(keys) else None
                sched = (after if isinstance(after, Mapping)
                         and set(after) == {"count"} else None)
                found.append((child, sched))
            else:
                walk(child)

    walk(opt_state)
    if len(found) != 1:
        raise ValueError(f"the JAX optimizer state holds {len(found)} Adam "
                         "states {count, mu, nu}; the port resumes exactly "
                         "one")
    return found[0]


def adam_state_dicts_from_jax(model, optimizer: torch.optim.Optimizer,
                              scheduler, opt_state: Mapping
                              ) -> Tuple[Dict, Optional[Dict]]:
    """A JAX run's optax state (`horopose_tpu/core/engine.py::
    make_optimizer`: clip, decay, adam) -> (a state dict for the port's
    `torch.optim.Adam` over `model`'s parameters, one for its LambdaLR or
    None), to load with their `load_state_dict`.

    - `exp_avg` / `exp_avg_sq` are adam's `mu` / `nu` through the weights'
      pairs and layout maps, keyed by each parameter's place in
      `optimizer.param_groups`; a parameter without a moment, or a moment
      without a parameter in the optimizer, raises.
    - `step` is adam's `count`: both bias corrections count the updates
      taken, and the next update is number count + 1.
    - The scheduler's `last_epoch` is the schedule's own count: the port's
      LambdaLR counts optimizer steps (`core/engine.py::make_optimizer`),
      and optax's next update takes lr(count), so each group's next LR is
      base_lr * lambda(count), as optax's."""
    mu_nu, sched = _adam_in_chain(opt_state)
    count = int(np.asarray(mu_nu["count"]))
    mu = params_like_from_jax(model, mu_nu["mu"])
    nu = params_like_from_jax(model, mu_nu["nu"])
    names = {id(p): n for n, p in model.named_parameters()}
    opt_sd = optimizer.state_dict()
    state, taken, i = {}, set(), 0
    for group in optimizer.param_groups:
        for p in group["params"]:
            name = names.get(id(p))
            if name is None:
                raise ValueError(f"optimizer parameter {i} is not a "
                                 "parameter of the model")
            if name not in mu:
                raise ValueError(f"torch parameter {name} has no Adam "
                                 "moment in the JAX optimizer state")
            if tuple(mu[name].shape) != tuple(p.shape):
                raise ValueError(f"{name}: Adam moment of shape "
                                 f"{tuple(mu[name].shape)}, parameter of "
                                 f"shape {tuple(p.shape)}")
            state[i] = {"step": torch.tensor(float(count)),
                        "exp_avg": mu[name], "exp_avg_sq": nu[name]}
            taken.add(name)
            i += 1
    left = sorted(set(mu) - taken)
    if left:
        raise ValueError(f"{len(left)} JAX Adam moments have no parameter "
                         f"in the optimizer, e.g. {left[0]}")
    opt_sd["state"] = state
    if scheduler is None:
        return opt_sd, None
    if not isinstance(scheduler, torch.optim.lr_scheduler.LambdaLR):
        raise TypeError(f"resuming a JAX schedule into "
                        f"{type(scheduler).__name__}: the port's schedule "
                        "is a LambdaLR")
    steps = count if sched is None else int(np.asarray(sched["count"]))
    lrs = [base * lam(steps) for base, lam in
           zip(scheduler.base_lrs, scheduler.lr_lambdas)]
    for group, lr in zip(opt_sd["param_groups"], lrs):
        group["lr"] = lr
    sched_sd = scheduler.state_dict()
    sched_sd.update(last_epoch=steps, _step_count=steps + 1, _last_lr=lrs)
    return opt_sd, sched_sd
