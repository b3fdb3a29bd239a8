"""Port supervised engine against `horopose_tpu.core` on the CPU.

One DREAM batch from `fixtures.make_synthetic_dream_dataset` through the
JAX `DreamDataset`/`DataLoader` at 64x64 crops goes to both packages: the
loss functions, the LR schedule, the optimizer on identical gradients,
`prepare_gt`, `compute_full_losses`, one whole train step and the eval
step. The whole step runs the flagship reg branch (resnet50 with its
deconv head) with a resnet18 rootnet: the JAX train step with the hrnet32
rootnet takes about 170 s to compile on this CPU, with resnet18 about 20 s.

Tolerances: forward values in f32 at 1e-5 relative; train-mode values
follow tests/test_train_dynamics_parity.py, where gradients through
batch-statistics BatchNorm are cancellation-dominated, so two correct f32
implementations differ by a few % of a leaf's max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fixtures import make_synthetic_dream_dataset
from horopose_tpu import constants as JC
from horopose_tpu.config import make_default_cfg
from horopose_tpu.core import engine as JE
from horopose_tpu.core import losses as JL
from horopose_tpu.data import DataLoader, DreamDataset
from horopose_tpu.kinematics import Robot as JaxRobot
from horopose_tpu.models import FullNet as JaxFullNet
from horopose_tpu.tools.torch_weights import (
    convert_fullnet_reference_checkpoint, merge_into)
from horopose_tpu_torch.core import engine as TE
from horopose_tpu_torch.core import losses as TL
from horopose_tpu_torch.kinematics import Robot
from horopose_tpu_torch.models import FullNet
from horopose_tpu_torch.pipelines.common import FullNetConfig
from horopose_tpu_torch.tools.jax_weights import fullnet_state_dict_from_jax

from test_torch_port_models import random_jax_variables

S, D, B = 64, 8, 4
REG, ROOT = "resnet50", "resnet18"
INIT_POSE = tuple(JC.initial_joint_vector("mean", "panda").tolist())
F32_RTOL = 1e-5
# train mode (tests/test_train_dynamics_parity.py:252-263)
LOSS_REL = 1e-3
GRAD_L2_REL, GRAD_MAX_REL, GRAD_COSINE = 5e-2, 0.3, 0.9999
# the same at the unconditioned random init (test_train_step_at_plain_...)
UNCONDITIONED_COSINE = 0.99
BN_REL, BN_ABS = 1e-4, 1e-7
# optimizer deltas on identical gradients: a few f32 ulp of an lr step
DELTA_REL = 5e-4
# the eval pipelines' `_valid` pad mask of a final partial batch
ROW_MASK = np.asarray([1.0, 1.0, 1.0, 0.0], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(**overrides):
    """(the JAX AttrDict config, the port's FullNetConfig) with the same
    values: the port's defaults (the flagship YAML) at 64x64, depth_dim 8,
    dropout off, plus `overrides`."""
    cfg = FullNetConfig(image_size=S, depth_dim=D, p_dropout=0.0,
                        backbone_name=REG, rootnet_backbone_name=ROOT)
    for k, v in overrides.items():
        setattr(cfg, k, v)
    jcfg = make_default_cfg()
    for k, v in vars(cfg).items():
        jcfg[k] = v
    jcfg.image_size = float(cfg.image_size)
    return jcfg, cfg


@pytest.fixture(scope="module")
def np_batch(tmp_path_factory):
    d = make_synthetic_dream_dataset(tmp_path_factory.mktemp("ds") / "dream",
                                     "panda", n_images=B, split="train_dr",
                                     seed=31)
    ds = DreamDataset(d, color_jitter=False, rgb_augmentation=False,
                      occlusion_augmentation=False,
                      rootnet_resize_hw=(S, S), other_resize_hw=(S, S))
    loader = DataLoader(ds, batch_size=B, num_workers=0, drop_last=False)
    batch = next(iter(loader))
    loader.close()
    batch["valid_mask"] = batch["valid_mask"].copy()
    batch["valid_mask"][0, 2] = 0.0       # one hidden keypoint: joints 2, 3
    return batch


@pytest.fixture(scope="module")
def robots():
    return JaxRobot("panda"), Robot("panda", device="cpu")


# ---- losses ----

def _loss_cases(rng):
    """name -> (fn(L, x, row_mask, asarray), x): L is either package's
    losses module and asarray its array maker."""
    a = rng.randn(B, 7, 3).astype(np.float32)
    b = rng.randn(B, 7, 3).astype(np.float32)
    mask = (rng.rand(B, 7) > 0.3).astype(np.float32)
    near = (b + 0.01 * rng.randn(B, 7, 3)).astype(np.float32)
    trans = "trans_l2norm_with_outlier_downweight"
    return {
        "row_mean": (lambda L, x, rm, ar: L.row_mean(x ** 2, rm), a),
        "mse": (lambda L, x, rm, ar: L.mse(x, ar(b), row_mask=rm), a),
        "l1": (lambda L, x, rm, ar: L.l1(x, ar(b), row_mask=rm), a),
        "smooth_l1": (lambda L, x, rm, ar: L.smooth_l1(
            x, ar(b * 0.5), row_mask=rm), a * 0.8),
        "masked_norm": (lambda L, x, rm, ar: L.masked_norm_loss(
            x, ar(b), None, row_mask=rm), a),
        "masked_norm_mask": (lambda L, x, rm, ar: L.masked_norm_loss(
            x, ar(b), ar(mask), row_mask=rm), a),
        "trans_far": (lambda L, x, rm, ar: getattr(L, trans)(
            x, ar(b), row_mask=rm), a),
        "trans_near": (lambda L, x, rm, ar: getattr(L, trans)(
            x, ar(b), row_mask=rm), near),
    }


@pytest.mark.parametrize("row_mask", [False, True])
@pytest.mark.parametrize("name", ["row_mean", "mse", "l1", "smooth_l1",
                                  "masked_norm", "masked_norm_mask",
                                  "trans_far", "trans_near"])
def test_loss_matches_jax(name, row_mask, rng):
    """Value and gradient; trans_far takes the down-weighted branch, whose
    weight is stop-gradient in JAX and detached in the port."""
    fn, x = _loss_cases(rng)[name]
    rm = ROW_MASK if row_mask else None
    ref, ref_grad = jax.value_and_grad(lambda v: fn(
        JL, v, None if rm is None else jnp.asarray(rm), jnp.asarray))(
            jnp.asarray(x))
    xt = _t(x).requires_grad_()
    out = fn(TL, xt, None if rm is None else _t(rm), _t)
    out.backward()
    np.testing.assert_allclose(out.item(), float(ref), rtol=F32_RTOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_grad),
                               rtol=F32_RTOL, atol=1e-7)


def test_elementwise_loss_rejects_unknown_kind():
    with pytest.raises(NotImplementedError):
        TL.elementwise_loss("huber", torch.zeros(2), torch.zeros(2))


# ---- schedule and optimizer ----

SCHEDULES = {
    "none": dict(use_schedule=False),
    "linear": dict(schedule_type="linear", start_decay=20, end_decay=90,
                   final_decay=0.05),
    "exponential": dict(schedule_type="exponential"),
    "everyXepoch": dict(schedule_type="everyXepoch", step=7, step_decay=0.5,
                        end_decay=100),
    "warmup": dict(schedule_type="exponential", n_epochs_warmup=5),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_ratio_matches_jax(name):
    jcfg, cfg = _cfgs(**SCHEDULES[name])
    epochs = np.arange(121)
    ref = np.asarray(JE.schedule_ratio(jcfg, jnp.asarray(epochs)))
    out = np.asarray([TE.schedule_ratio(cfg, int(e)) for e in epochs])
    # JAX takes the powers in f32
    np.testing.assert_allclose(out, ref, rtol=2e-6)


@pytest.mark.parametrize("clip", [0.5, 100.0], ids=["clipped", "unclipped"])
def test_optimizer_matches_optax_on_identical_gradients(clip, rng):
    """Two steps, one epoch each, so the LR changes between them; coupled
    weight decay on; clipping triggered or not."""
    jcfg, cfg = _cfgs(lr=1e-3, weight_decay=1e-2, clip_gradient=clip,
                      start_decay=0, exponent=0.5)
    shapes = {"a": (4, 5), "b": (7,), "c": (3, 2, 2)}
    params0 = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) * 0.3
              for k, s in shapes.items()} for _ in range(2)]

    tx = JE.make_optimizer(jcfg, steps_per_epoch=1)
    jparams = {k: jnp.asarray(v) for k, v in params0.items()}
    state = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(_t(v)) for k, v in params0.items()}
    opt, sched = TE.make_optimizer(cfg, list(tparams.values()), 1)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = _t(g[k])
        norm = TE.clip_by_global_norm_(list(tparams.values()), clip)
        assert (float(norm) > clip) == (clip < 1.0)
        opt.step()
        sched.step()
    for k in shapes:
        ref = np.asarray(jparams[k]) - params0[k]
        out = tparams[k].detach().numpy() - params0[k]
        np.testing.assert_allclose(out, ref, rtol=DELTA_REL,
                                   atol=cfg.lr * 1e-3, err_msg=k)


# ---- prepare_gt ----

@pytest.mark.parametrize("ref_kp", [0, 3])
@pytest.mark.parametrize("joint_mask", [False, True])
@pytest.mark.parametrize("bbox", ["extended", "origin", "strict"])
def test_prepare_gt_matches_jax(bbox, joint_mask, ref_kp, np_batch, robots):
    jcfg, cfg = _cfgs(use_extended_bbox=bbox == "extended",
                      use_origin_bbox=bbox == "origin",
                      use_joint_valid_mask=joint_mask,
                      reference_keypoint_id=ref_kp)
    jrobot, trobot = robots
    ref = JE.prepare_gt(jcfg, jrobot, jax.tree.map(jnp.asarray, np_batch))
    out = TE.prepare_gt(cfg, trobot, TE.batch_to_torch(np_batch, "cpu"))
    assert sorted(out) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=F32_RTOL, atol=1e-6, err_msg=k)
    if joint_mask:
        assert not np.allclose(out["gt_pose"], out["gt_pose_before_mask"])


def test_prepare_gt_rejects_unported_options(np_batch, robots):
    """No option is left unported (the name is kept from when rotation_dim
    4 raised): the quaternion ground truth, the root's rotation included,
    matches JAX (more cases in tests/test_torch_port_variants.py)."""
    jcfg4, cfg4 = _cfgs(rotation_dim=4)
    ref = JE.prepare_gt(jcfg4, robots[0], jax.tree.map(jnp.asarray, np_batch))
    out = TE.prepare_gt(cfg4, robots[1], TE.batch_to_torch(np_batch, "cpu"))
    for k in ("gt_rot", "gt_root_rot"):
        assert out[k].shape == (B, 4)
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=F32_RTOL, atol=1e-6, err_msg=k)


# ---- compute_full_losses ----

LOSS_VARIANTS = {
    "flagship": {},
    "variants": dict(rot_loss_func="mat_mse", uv_loss_func="smoothl1",
                     trans_loss_func="l1", depth_loss_func="mse",
                     fix_mask=True, align_3d_loss_weight=2.0,
                     joint_individual_weights=[1, 2, 1, 1, 3, 1, 1, 0.5]),
    "known_joint": dict(known_joint=True, pose_loss_func="l1"),
}


def _preds(rng):
    kp = rng.randn(B, 7, 3) * 0.2 + [0, 0, 1.5]
    return dict(pose=rng.randn(B, 8), rot=rng.randn(B, 6),
                trans=rng.randn(B, 3) * 0.3, root_uv=rng.uniform(0, S, (B, 2)),
                depth=rng.uniform(0.5, 2, (B, 1)), xyz_int=kp,
                xyz_fk=kp + rng.randn(B, 7, 3) * 0.05)


@pytest.mark.parametrize("row_mask", [False, True])
@pytest.mark.parametrize("variant", sorted(LOSS_VARIANTS))
def test_compute_full_losses_matches_jax(variant, row_mask, np_batch, robots,
                                         rng):
    jcfg, cfg = _cfgs(**LOSS_VARIANTS[variant])
    jrobot, trobot = robots
    preds = {k: v.astype(np.float32) for k, v in _preds(rng).items()}
    rm = ROW_MASK if row_mask else None
    jb = jax.tree.map(jnp.asarray, np_batch)
    ref, ref_dict = JE.compute_full_losses(
        jcfg, {k: jnp.asarray(v) for k, v in preds.items()},
        JE.prepare_gt(jcfg, jrobot, jb), jb["other"]["K"],
        row_mask=None if rm is None else jnp.asarray(rm))
    tb = TE.batch_to_torch(np_batch, "cpu")
    out, out_dict = TE.compute_full_losses(
        cfg, {k: _t(v) for k, v in preds.items()},
        TE.prepare_gt(cfg, trobot, tb), tb["other"]["K"],
        row_mask=None if rm is None else _t(rm))
    assert sorted(out_dict) == sorted(ref_dict)
    for k in ref_dict:
        np.testing.assert_allclose(float(out_dict[k]), float(ref_dict[k]),
                                   rtol=F32_RTOL, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(out), float(ref), rtol=F32_RTOL)


def test_compute_full_losses_rejects_multi_kp(np_batch, robots, rng):
    """A multi_kp head's per-keypoint depths have their loss now (the name
    is kept from when they raised): the L1 on the chosen keypoints'
    depths joins the sum as in JAX (more cases in
    tests/test_torch_port_variants.py)."""
    jcfg, cfg = _cfgs(multi_kp=True, kps_need_depth=[1, 3, 5])
    preds = {k: v.astype(np.float32) for k, v in _preds(rng).items()}
    preds["depths"] = rng.uniform(0.5, 2, (B, 3)).astype(np.float32)
    jb = jax.tree.map(jnp.asarray, np_batch)
    ref, _ = JE.compute_full_losses(
        jcfg, {k: jnp.asarray(v) for k, v in preds.items()},
        JE.prepare_gt(jcfg, robots[0], jb), jb["other"]["K"])
    tb = TE.batch_to_torch(np_batch, "cpu")
    out, _ = TE.compute_full_losses(
        cfg, {k: _t(v) for k, v in preds.items()},
        TE.prepare_gt(cfg, robots[1], tb), tb["other"]["K"])
    np.testing.assert_allclose(float(out), float(ref), rtol=F32_RTOL)


# ---- the whole train step and the eval step ----

def _recording(tx):
    """`tx` that also keeps the raw gradients it was given in its state."""
    def init(params):
        return tx.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


def _jax_model():
    return JaxFullNet(image_size=S, depth_dim=D, p_dropout=0.0,
                      backbone_name=REG, rootnet_backbone_name=ROOT,
                      init_pose=INIT_POSE)


def _port_model(variables):
    model = FullNet(image_size=S, depth_dim=D, p_dropout=0.0,
                    backbone_name=REG, rootnet_backbone_name=ROOT,
                    init_pose=INIT_POSE)
    model.load_state_dict(_to_torch(variables["params"],
                                    variables["batch_stats"]))
    return model


def _to_torch(params, batch_stats):
    return fullnet_state_dict_from_jax(
        jax.tree.map(np.array, params), jax.tree.map(np.array, batch_stats),
        REG, ROOT)


def _random_variables():
    """The flagship's random weights as `random_jax_variables` draws them."""
    args = (np.zeros((1, S, S, 3), np.float32),
            np.zeros((1, S, S, 3), np.float32), np.ones((1,), np.float32),
            np.eye(3, dtype=np.float32)[None])
    return random_jax_variables(_jax_model(), args, seed=7)


@pytest.fixture(scope="module")
def variables(np_batch, robots):
    """Random weights, conditioned so that f32 rounding is not amplified
    past the tolerances:
    - the last BatchNorm scale of each residual branch is 0.05 (0.1 times
      the usual 0.5), as torchvision's zero_init_residual damps them. With
      0.5, train-mode BatchNorm at init explodes the gradients backwards
      (reg conv1's gradient norm 17,000 against 120) and both packages'
      rounding with them (test_train_step_at_plain_random_init);
    - the root depth head predicts about the batch's own root depths. With
      a random one the FK keypoints land near or behind the camera plane,
      where the 2-D projection losses are ill-conditioned (a 1e-4 change
      in the pose moved loss_error2d by 1%)."""
    variables = _random_variables()
    jcfg, _ = _cfgs()
    gts = JE.prepare_gt(jcfg, robots[0], jax.tree.map(jnp.asarray, np_batch))
    gamma = np.mean(np.asarray(gts["gt_root_depth"])[:, 0] * 1000.0 /
                    np.asarray(gts["k_values"]))
    for backbone, last_bn in (("reg_backbone", "BatchNorm_2"),
                              ("rootnet_backbone", "BatchNorm_1")):
        for name, block in variables["params"][backbone].items():
            if name.startswith("layer"):
                block[last_bn]["scale"] = block[last_bn]["scale"] * 0.1
    head = variables["params"]["depth_layer"]
    head["kernel"] = head["kernel"] * 1e-3
    head["bias"] = np.full_like(head["bias"], gamma)
    return variables


@pytest.fixture(scope="module")
def jax_train_step(robots):
    """(tx, the JAX `build_full_train_step` over it), built once so that
    every weight set reuses one compilation."""
    jcfg, _ = _cfgs()
    tx = JE.make_optimizer(jcfg, 1)
    return tx, JE.build_full_train_step(jcfg, _jax_model(), robots[0],
                                        _recording(tx))


def _run_train_steps(np_batch, variables, robots, jax_train_step):
    """One JAX train step and one port train step on the same batch and
    weights; the port's raw gradients are caught on their way into the
    clipping."""
    _, cfg = _cfgs()
    tx, step = jax_train_step
    state = JE.create_train_state(variables, _recording(tx))
    new_state, jlogs = step(state, jax.tree.map(jnp.asarray, np_batch),
                            jax.random.PRNGKey(0))

    model = _port_model(variables)
    pre = {k: v.clone() for k, v in model.state_dict().items()}
    opt, sched = TE.make_optimizer(cfg, model.parameters(), 1)
    raw = {}
    clip = TE.clip_by_global_norm_

    def catching_clip(params, max_norm):
        raw.update({k: p.grad.clone() for k, p in model.named_parameters()})
        return clip(params, max_norm)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TE, "clip_by_global_norm_", catching_clip)
        logs = TE.build_full_train_step(cfg, model, robots[1], opt, sched)(
            TE.batch_to_torch(np_batch, "cpu"), None)
    return dict(
        jlogs={k: float(v) for k, v in jlogs.items()},
        logs={k: float(v) for k, v in logs.items()},
        jgrads=_to_torch(new_state.opt_state[1], new_state.batch_stats),
        jpost=_to_torch(new_state.params, new_state.batch_stats),
        grads=raw, pre=pre, post=model.state_dict(), tx=tx,
        variables=variables, lr=cfg.lr)


@pytest.fixture(scope="module")
def train_step(np_batch, variables, robots, jax_train_step):
    return _run_train_steps(np_batch, variables, robots, jax_train_step)


def _assert_losses_match(step):
    assert sorted(step["logs"]) == sorted(step["jlogs"])
    for k, ref in step["jlogs"].items():
        out = step["logs"][k]
        assert np.isfinite(out), k
        assert abs(out - ref) / max(abs(ref), 1e-3) < LOSS_REL, (k, out, ref)


def _gradient_cosine(step):
    grads, jgrads = step["grads"], step["jgrads"]
    a = np.concatenate([grads[k].double().numpy().ravel() for k in grads])
    b = np.concatenate([jgrads[k].double().numpy().ravel() for k in grads])
    return a @ b / (np.linalg.norm(a) * np.linalg.norm(b))


def test_train_step_losses_match_jax(train_step):
    _assert_losses_match(train_step)


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
    assert _gradient_cosine(train_step) > GRAD_COSINE
    # the heatmap head sits right after the soft-argmax backward
    np.testing.assert_allclose(grads["final_layer.weight"].numpy(),
                               jgrads["final_layer.weight"].numpy(),
                               rtol=GRAD_L2_REL,
                               atol=1e-3 * float(jgrads[
                                   "final_layer.weight"].abs().max()))


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
    """The port's post-step parameters against the JAX optax chain applied
    to the port's own gradients: Adam's first step is +-lr on every entry
    with |g| >> eps, so gradients that differ only by BN cancellation noise
    flip tiny entries by 2 lr; identical gradients leave a few f32 ulp."""
    variables, tx = train_step["variables"], train_step["tx"]
    names = dict(train_step["grads"])
    grad_sd = {k: np.zeros(v.shape, np.float32)
               for k, v in train_step["pre"].items()
               if not k.endswith("num_batches_tracked")}
    grad_sd.update({k: v.numpy() for k, v in names.items()})
    jgrads = merge_into(variables, convert_fullnet_reference_checkpoint(
        grad_sd, REG, ROOT))["params"]
    updates, _ = jax.jit(tx.update)(jgrads, tx.init(variables["params"]),
                                    variables["params"])
    ref_post = _to_torch(optax.apply_updates(variables["params"], updates),
                         variables["batch_stats"])
    lr = train_step["lr"]
    for k in names:
        pre = train_step["pre"][k]
        out = train_step["post"][k] - pre
        ref = ref_post[k] - pre
        assert float(out.abs().max()) > 0.5 * lr, k        # a step was taken
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=DELTA_REL,
                                   atol=lr * 1e-3, err_msg=k)


def test_train_step_at_plain_random_init(np_batch, robots, jax_train_step):
    """The same step on `random_jax_variables` as drawn, unconditioned: the
    losses still match, but train-mode BatchNorm amplifies both packages'
    f32 rounding backwards through the net, so the gradients agree less
    well than the conditioned step's. Prints the reading PERF.md cites."""
    step = _run_train_steps(np_batch, _random_variables(), robots,
                            jax_train_step)
    _assert_losses_match(step)
    cos = _gradient_cosine(step)
    grads, jgrads = step["grads"], step["jgrads"]
    l2 = max(float((grads[k] - jgrads[k]).norm() / jgrads[k].norm())
             for k in grads if float(jgrads[k].norm()) > 0)
    print(f"plain random init: global gradient cosine {cos:.7f}, worst "
          f"leaf l2-relative {l2:.3e}")
    assert cos > UNCONDITIONED_COSINE


@pytest.mark.parametrize("valid", [False, True])
def test_eval_step_matches_jax(valid, np_batch, variables, robots):
    jcfg, cfg = _cfgs()
    jrobot, trobot = robots
    batch = dict(np_batch)
    if valid:
        batch["_valid"] = ROW_MASK
    state = JE.create_train_state(variables, JE.make_optimizer(jcfg, 1))
    _, jgts, jlogs = JE.build_full_eval_step(jcfg, _jax_model(), jrobot)(
        state, jax.tree.map(jnp.asarray, batch))
    model = _port_model(variables)
    _, gts, logs = TE.build_full_eval_step(cfg, model, trobot)(
        TE.batch_to_torch(batch, "cpu"))
    assert not model.training
    assert sorted(logs) == sorted(jlogs)
    for k, ref in jlogs.items():
        ref = float(ref)
        assert abs(float(logs[k]) - ref) / max(abs(ref), 1e-3) < 1e-4, k
    np.testing.assert_allclose(gts["k_values"].numpy(),
                               np.asarray(jgts["k_values"]), rtol=F32_RTOL)


def test_synthetic_batch_has_the_dream_layout(np_batch, robots):
    """The port's synthetic batch (chip_smoke.py's training data) carries
    every key `prepare_gt` reads, in the DataLoader's shapes and dtypes,
    and the JAX `prepare_gt` reads it as the port's does."""
    from horopose_tpu_torch.data.synthetic import synthetic_dream_batch
    jcfg, cfg = _cfgs()
    jrobot, trobot = robots
    batch = synthetic_dream_batch(trobot, B, S, S, seed=3, device="cpu")

    def layout(tree):
        return {k: layout(v) if isinstance(v, dict)
                else (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in tree.items()}

    ours, ref = layout(batch), layout(np_batch)
    for k, v in ours.items():
        assert v == ref[k], k
    gts = TE.prepare_gt(cfg, trobot, batch)
    jgts = JE.prepare_gt(jcfg, jrobot, jax.tree.map(
        lambda t: jnp.asarray(t.numpy()), batch))
    for k in jgts:
        np.testing.assert_allclose(gts[k].numpy(), np.asarray(jgts[k]),
                                   rtol=F32_RTOL, atol=1e-6, err_msg=k)
    # the FK keypoints project onto the crop's 2-D keypoints
    kp = batch["other"]["keypoints_3d"]
    uv = kp[..., :2] / kp[..., 2:] * batch["other"]["K"][:, None, [0, 1],
                                                         [0, 1]]
    uv = uv + batch["other"]["K"][:, None, :2, 2]
    np.testing.assert_allclose(uv.numpy(),
                               batch["other"]["keypoints_2d"].numpy(),
                               rtol=1e-5, atol=1e-3)
    assert float(gts["k_values"].min()) > 0
