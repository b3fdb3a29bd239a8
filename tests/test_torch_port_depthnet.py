"""Port DepthNet (stage 1) against the JAX package on the CPU.

`RootNet` in eval mode against the JAX `RootNet` (hrnet32 and resnet34,
every option the backbone allows), with numpy-random variables on the
`jax.eval_shape` tree carried over by `rootnet_state_dict_from_jax`; the
converter against the JAX package's torch -> flax map; `prepare_depth_gt`;
and one DepthNet train step and the eval step against
`build_depthnet_train_step` / `build_depthnet_eval_step` on a DREAM batch
from `fixtures.make_synthetic_dream_dataset`. The steps run RootNet with a
resnet34 backbone at 64x64 crops, B=4 (a JAX hrnet32 train step takes
minutes to compile on this CPU).

Tolerances: forward values at 1e-4 relative to the output's max (the
repo's f32 parity bound); the train step as tests/test_torch_port_engine.py
holds the stage-2 step: loss at 1e-4 relative, gradients by leaf and by
cosine, BN running statistics, and the updated parameters against the JAX
optax chain applied to the port's own gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import make_synthetic_dream_dataset
from horopose_tpu.config import make_cfg as jax_make_cfg
from horopose_tpu.core import engine as JE
from horopose_tpu.data import DataLoader, DreamDataset
from horopose_tpu.models.depth_net import RootNet as JaxRootNet
from horopose_tpu.tools.torch_weights import (
    convert_rootnet_reference_checkpoint, merge_into)
from horopose_tpu_torch.config import make_cfg
from horopose_tpu_torch.core import engine as TE
from horopose_tpu_torch.models import RootNet
from horopose_tpu_torch.pipelines.common import random_state_dict
from horopose_tpu_torch.tools.jax_weights import rootnet_state_dict_from_jax

from test_torch_port_engine import (BN_ABS, BN_REL, DELTA_REL, GRAD_COSINE,
                                    GRAD_L2_REL, GRAD_MAX_REL, ROW_MASK,
                                    _recording)
from test_torch_port_models import random_jax_variables, rel_err

S, B = 64, 4
REL_TOL = 1e-4
CONFIG = "configs/panda/depthnet.yaml"
STEP_BACKBONE = "resnet34"


def _cfgs(**overrides):
    """(JAX config, port config) of configs/panda/depthnet.yaml, each read
    by its own package, at 64x64 with a resnet34 backbone, plus
    `overrides`."""
    out = []
    for cfg in (jax_make_cfg(CONFIG), make_cfg(CONFIG)):
        cfg.update(backbone_name=STEP_BACKBONE, image_size=float(S),
                   batch_size=B, **overrides)
        out.append(cfg)
    return tuple(out)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _jax_variables(jmodel, seed):
    return random_jax_variables(
        jmodel, (np.zeros((1, S, S, 3), np.float32),
                 np.ones((1,), np.float32)), seed)


def _port_model(variables, backbone, **flags):
    model = RootNet(backbone_name=backbone, input_size=S, **flags)
    model.load_state_dict(rootnet_state_dict_from_jax(
        variables["params"], variables["batch_stats"], backbone))
    return model


# ---- the model ----

FORWARD_CASES = {
    # pred_xy reads a resnet feature map, so hrnet32 takes the other two
    "hrnet32": ("hrnet32", dict(use_offset=True, add_fc=True)),
    "resnet34": ("resnet34", dict(pred_xy=True, use_offset=True,
                                  add_fc=True)),
}


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_rootnet_forward_matches_jax(case, rng):
    backbone, flags = FORWARD_CASES[case]
    jmodel = JaxRootNet(backbone_name=backbone, input_size=S, **flags)
    variables = _jax_variables(jmodel, seed=4)
    x = rng.rand(2, S, S, 3).astype(np.float32)
    k = rng.uniform(800, 1800, 2).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, a, b: jmodel.apply(
        v, a, b, train=False))(variables, x, k))
    model = _port_model(variables, backbone, **flags).eval()
    with torch.no_grad():
        out = model(_nchw(x), torch.from_numpy(k)).numpy()
    assert out.shape == ref.shape == (2, 3 if flags.get("pred_xy") else 1)
    assert np.isfinite(out).all()
    assert rel_err(out, ref) <= REL_TOL
    if flags.get("pred_xy"):          # the xy columns on their own scale
        assert rel_err(out[:, :2], ref[:, :2]) <= REL_TOL


@pytest.mark.parametrize("backbone,flags", [
    ("hrnet32", {}), ("resnet34", dict(pred_xy=True, use_offset=True,
                                       add_fc=True)), ("resnet50", {})])
def test_state_dict_round_trips_through_jax_layout(backbone, flags):
    """port state_dict -> convert_rootnet_reference_checkpoint (the JAX
    package's torch -> flax map) -> rootnet_state_dict_from_jax gives back
    every key, bit for bit."""
    model = RootNet(backbone_name=backbone, **flags)
    sd = {k: v.numpy() for k, v in random_state_dict(model, 3).items()
          if not k.endswith("num_batches_tracked")}
    tb = convert_rootnet_reference_checkpoint(sd, backbone)
    back = rootnet_state_dict_from_jax(tb.params, tb.batch_stats, backbone)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    model.load_state_dict(back)      # strict: every module key is present


def test_from_jax_names_the_backbone_subtree():
    """The JAX RootNet's auto-named backbone subtree (`ResNet_0`) is the
    port's `backbone`; a leaf with no torch key raises."""
    model = RootNet(backbone_name="resnet34")
    sd = {k: v.numpy() for k, v in random_state_dict(model, 0).items()}
    tb = convert_rootnet_reference_checkpoint(sd, "resnet34")
    assert "ResNet_0" in tb.params
    back = rootnet_state_dict_from_jax(tb.params, tb.batch_stats, "resnet34")
    np.testing.assert_array_equal(
        back["backbone.conv1.weight"].numpy(),
        np.transpose(tb.params["ResNet_0"]["conv1"]["kernel"], (3, 2, 0, 1)))
    tb.params["stray_head"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="stray_head"):
        rootnet_state_dict_from_jax(tb.params, tb.batch_stats, "resnet34")


def test_rootnet_rejects_what_the_jax_model_cannot_run():
    with pytest.raises(ValueError, match="pred_xy"):
        RootNet(backbone_name="hrnet32", pred_xy=True)
    with pytest.raises(NotImplementedError):
        RootNet(backbone_name="resnet18")


def test_bf16_rootnet_keeps_heads_f32(rng):
    model = RootNet(backbone_name="resnet34", pred_xy=True, use_offset=True,
                    add_fc=True, dtype=torch.bfloat16)
    model.load_state_dict(random_state_dict(model, 0))
    model.eval()
    seen = {}
    for name in ("xy_layer", "depth_fc1", "depth_layer", "offset_layer"):
        getattr(model, name).register_forward_hook(
            lambda _m, _i, out, name=name: seen.update({name: out.dtype}))
    with torch.no_grad():
        out = model(_nchw(rng.rand(2, S, S, 3).astype(np.float32)),
                    torch.full((2,), 1000.0))
    assert seen == {"xy_layer": torch.bfloat16, "depth_fc1": torch.float32,
                    "depth_layer": torch.float32,
                    "offset_layer": torch.float32}
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


# ---- ground truth and the steps ----

@pytest.fixture(scope="module")
def np_batch(tmp_path_factory):
    d = make_synthetic_dream_dataset(tmp_path_factory.mktemp("ds") / "dream",
                                     "panda", n_images=B, split="train_dr",
                                     seed=41)
    ds = DreamDataset(d, color_jitter=False, rgb_augmentation=False,
                      occlusion_augmentation=False,
                      rootnet_resize_hw=(S, S), other_resize_hw=(S, S))
    loader = DataLoader(ds, batch_size=B, num_workers=0, drop_last=False)
    batch = next(iter(loader))
    loader.close()
    batch["root"]["valid_mask_crop"] = batch["root"]["valid_mask_crop"].copy()
    batch["root"]["valid_mask_crop"][1, 3] = 0.0     # the root hidden once
    return batch


@pytest.mark.parametrize("ref_kp", [0, 3])
@pytest.mark.parametrize("bbox", ["extended", "origin", "strict"])
def test_prepare_depth_gt_matches_jax(bbox, ref_kp, np_batch):
    jcfg, cfg = _cfgs(use_extended_bbox=bbox == "extended",
                      use_origin_bbox=bbox == "origin",
                      reference_keypoint_id=ref_kp)
    ref = JE.prepare_depth_gt(jcfg, jax.tree.map(jnp.asarray, np_batch))
    out = TE.prepare_depth_gt(cfg, TE.batch_to_torch(np_batch, "cpu"))
    assert sorted(out) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def _conditioned(jmodel, jcfg, np_batch, seed):
    """Random variables with each residual branch's last BN scale x0.1 and
    the depth head at the batch's depths, as the stage-2 step test
    conditions them (else train-mode BN amplifies f32 rounding)."""
    variables = _jax_variables(jmodel, seed)
    gts = JE.prepare_depth_gt(jcfg, jax.tree.map(jnp.asarray, np_batch))
    gamma = np.mean(np.asarray(gts["gt_root_depth"])[:, 0] * 1000.0 /
                    np.asarray(gts["k_values"]))
    for name, block in variables["params"]["ResNet_0"].items():
        if name.startswith("layer"):
            block["BatchNorm_1"]["scale"] = block["BatchNorm_1"]["scale"] * 0.1
    head = variables["params"]["depth_layer"]
    head["kernel"] = head["kernel"] * 1e-3
    head["bias"] = np.full_like(head["bias"], gamma)
    return variables


def _to_torch(params, batch_stats):
    return rootnet_state_dict_from_jax(
        jax.tree.map(np.array, params), jax.tree.map(np.array, batch_stats),
        STEP_BACKBONE)


@pytest.fixture(scope="module")
def train_step(np_batch):
    """One JAX and one port DepthNet train step on the same batch and
    weights; the port's raw gradients are caught on their way into the
    clipping, the JAX ones by a recording optax stage."""
    jcfg, cfg = _cfgs()
    jmodel = JaxRootNet(backbone_name=STEP_BACKBONE, input_size=S)
    variables = _conditioned(jmodel, jcfg, np_batch, seed=9)
    tx = JE.make_optimizer(jcfg, 1)
    state = JE.create_train_state(variables, _recording(tx))
    new_state, jlogs = JE.build_depthnet_train_step(
        jcfg, jmodel, _recording(tx))(
            state, jax.tree.map(jnp.asarray, np_batch), jax.random.PRNGKey(0))

    model = _port_model(variables, STEP_BACKBONE)
    pre = {k: v.clone() for k, v in model.state_dict().items()}
    opt, sched = TE.make_optimizer(cfg, model.parameters(), 1)
    raw = {}
    clip = TE.clip_by_global_norm_

    def catching_clip(params, max_norm):
        raw.update({k: p.grad.clone() for k, p in model.named_parameters()})
        return clip(params, max_norm)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TE, "clip_by_global_norm_", catching_clip)
        logs = TE.build_depthnet_train_step(cfg, model, opt, sched)(
            TE.batch_to_torch(np_batch, "cpu"))
    return dict(jloss=float(jlogs["loss"]), loss=float(logs["loss"]),
                jgrads=_to_torch(new_state.opt_state[1],
                                 new_state.batch_stats),
                jpost=_to_torch(new_state.params, new_state.batch_stats),
                grads=raw, pre=pre, post=model.state_dict(), tx=tx,
                variables=variables, lr=cfg.lr, clip=cfg.clip_gradient)


def test_train_step_loss_matches_jax(train_step):
    assert train_step["clip"] == 1.0       # stage 1's clip, from the YAML
    assert np.isfinite(train_step["loss"])
    assert abs(train_step["loss"] - train_step["jloss"]) <= \
        REL_TOL * abs(train_step["jloss"])


def test_train_step_gradients_match_jax(train_step):
    grads, jgrads = train_step["grads"], train_step["jgrads"]
    assert sorted(grads) and set(grads) <= set(jgrads)
    gnorm = max(float(jgrads[k].norm()) for k in grads)
    gscale = max(float(jgrads[k].abs().max()) for k in grads)
    bad = []
    for k, g in grads.items():
        a, b = g.double().numpy(), jgrads[k].double().numpy()
        l2 = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-3 * gnorm)
        mx = np.abs(a - b).max() / max(np.abs(b).max(), 1e-3 * gscale)
        if l2 > GRAD_L2_REL or mx > GRAD_MAX_REL:
            bad.append(f"{k}: l2rel {l2:.3e} maxrel {mx:.3e}")
    assert not bad, "\n".join(bad[:12])
    va = np.concatenate([grads[k].double().numpy().ravel() for k in grads])
    vb = np.concatenate([jgrads[k].double().numpy().ravel() for k in grads])
    assert va @ vb / (np.linalg.norm(va) * np.linalg.norm(vb)) > GRAD_COSINE


def test_train_step_bn_running_stats_match_jax(train_step):
    keys = [k for k in train_step["post"]
            if k.endswith(("running_mean", "running_var"))]
    assert keys
    scale = max(float(train_step["jpost"][k].abs().max()) for k in keys)
    for k in keys:
        out, ref = train_step["post"][k], train_step["jpost"][k]
        assert not torch.equal(out, train_step["pre"][k]), k
        tol = BN_REL * max(float(ref.abs().max()), 1e-3 * scale) + BN_ABS
        assert float((out - ref).abs().max()) <= tol, k


def test_train_step_params_match_optax_on_its_gradients(train_step):
    """The port's updated parameters against the JAX chain (clip 1.0, Adam)
    applied to the port's own raw gradients."""
    variables, tx = train_step["variables"], train_step["tx"]
    grad_sd = {k: np.zeros(v.shape, np.float32)
               for k, v in train_step["pre"].items()
               if not k.endswith("num_batches_tracked")}
    grad_sd.update({k: v.numpy() for k, v in train_step["grads"].items()})
    jgrads = merge_into(variables, convert_rootnet_reference_checkpoint(
        grad_sd, STEP_BACKBONE))["params"]
    updates, _ = jax.jit(tx.update)(jgrads, tx.init(variables["params"]),
                                    variables["params"])
    ref_post = _to_torch(optax_apply(variables["params"], updates),
                         variables["batch_stats"])
    lr = train_step["lr"]
    for k in train_step["grads"]:
        pre = train_step["pre"][k]
        out = train_step["post"][k] - pre
        ref = ref_post[k] - pre
        assert float(out.abs().max()) > 0.5 * lr, k        # a step was taken
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=DELTA_REL,
                                   atol=lr * 1e-3, err_msg=k)


def optax_apply(params, updates):
    import optax
    return optax.apply_updates(params, updates)


@pytest.mark.parametrize("xy,valid", [(False, False), (True, True)],
                         ids=["depth", "xy_branch_row_mask"])
def test_eval_step_matches_jax(xy, valid, np_batch):
    jcfg, cfg = _cfgs(use_rootnet_xy_branch=xy)
    jmodel = JaxRootNet(backbone_name=STEP_BACKBONE, pred_xy=xy,
                        input_size=S)
    variables = _conditioned(jmodel, jcfg, np_batch, seed=11)
    batch = dict(np_batch)
    if valid:
        batch["_valid"] = ROW_MASK
    state = JE.create_train_state(variables, JE.make_optimizer(jcfg, 1))
    ref = JE.build_depthnet_eval_step(jcfg, jmodel)(
        state, jax.tree.map(jnp.asarray, batch))
    model = _port_model(variables, STEP_BACKBONE, pred_xy=xy)
    out = TE.build_depthnet_eval_step(cfg, model)(
        TE.batch_to_torch(batch, "cpu"))
    assert not model.training
    assert sorted(out) == sorted(ref)
    for k in ref:
        assert rel_err(out[k].numpy(), np.asarray(ref[k])) <= REL_TOL, k
