"""The non-flagship FullNet variants of the port against the JAX package.

Every flag `horopose_tpu.pipelines.common.build_fullnet` can set: add_fc,
multi_kp, reg_joint_map, direct_reg_rot, rot_iterative_matmul and
quaternion rotations (rotation_dim 4), and the pieces around them (the
quaternion and 9-D rotation maps, `prepare_gt` at rotation_dim 4, the
multi_kp depth loss, the config plumbing and the weight map).

Forward parity runs a resnet50 reg backbone with a resnet18 rootnet at
64x64 crops and depth_dim 8, in eval mode, on JAX variables made from a
numpy seed on the `jax.eval_shape(model.init)` tree and carried across
by `fullnet_state_dict_from_jax`. The V1 train step (add_fc, multi_kp,
reg_joint_map, rot_iterative_matmul) runs at the smallest size, resnet18
backbones, against the JAX `build_full_train_step`, its weights
conditioned as `tests/test_torch_port_engine.py` conditions the
flagship's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import make_synthetic_dream_dataset
from horopose_tpu import constants as JC
from horopose_tpu.config import make_default_cfg
from horopose_tpu.core import engine as JE
from horopose_tpu.data import DataLoader, DreamDataset
from horopose_tpu.kinematics import Robot as JaxRobot
from horopose_tpu.ops import rotations as JR
from horopose_tpu.pipelines.common import build_fullnet as jax_build_fullnet
from horopose_tpu_torch.core import engine as TE
from horopose_tpu_torch.kinematics import Robot
from horopose_tpu_torch.ops import rotations as TR
from horopose_tpu_torch.pipelines.common import FullNetConfig, build_fullnet
from horopose_tpu_torch.tools.jax_weights import fullnet_state_dict_from_jax

from test_torch_port_engine import _recording
from test_torch_port_models import (_inputs, _nchw, random_jax_variables,
                                    rel_err)

S, D, B = 64, 8, 4
REG, ROOT = "resnet50", "resnet18"
REL_TOL = 1e-4
F32_TOL = 1e-6
# the train step's bounds, tighter than the flagship test's: no hrnet
LOSS_REL, GRAD_COSINE = 1e-5, 0.99999

VARIANTS = {
    "v1": dict(add_fc=True, multi_kp=True, kps_need_depth=list(range(7)),
               reg_joint_map=True, joint_conv_dim=[64, 64, 64],
               rot_iterative_matmul=True),
    "v2": dict(direct_reg_rot=True, rotation_dim=4),
    "joint_map_add_fc": dict(reg_joint_map=True, joint_conv_dim=[32, 16],
                             add_fc=True),
}
BASE_KEYS = ["pose", "rot", "trans", "root_uv", "depth", "uvd", "xyz_int"]
FORWARD_CASES = [(v, k) for v in VARIANTS for k in BASE_KEYS] + \
    [("v1", "depths")]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(reg=REG, **flags):
    """(the JAX config, the port's FullNetConfig): the flagship's keys at
    64x64, depth_dim 8, dropout off, with `flags`."""
    cfg = FullNetConfig(image_size=S, depth_dim=D, p_dropout=0.0,
                        backbone_name=reg, rootnet_backbone_name=ROOT)
    for k, v in flags.items():
        setattr(cfg, k, v)
    jcfg = make_default_cfg()
    for k, v in vars(cfg).items():
        jcfg[k] = v
    jcfg.image_size = float(cfg.image_size)
    return jcfg, cfg


def _models(variant, reg=REG):
    """(JAX FullNet, port FullNet) from each package's build_fullnet."""
    jcfg, cfg = _cfgs(reg, **VARIANTS[variant])
    jmodel = jax_build_fullnet(jcfg).clone(depth_dim=D)
    return jmodel, build_fullnet(cfg), cfg


def _to_torch(params, batch_stats, reg=REG):
    return fullnet_state_dict_from_jax(
        jax.tree.map(np.array, params), jax.tree.map(np.array, batch_stats),
        reg, ROOT)


def _load(model, variables, reg=REG):
    model.load_state_dict(_to_torch(variables["params"],
                                    variables["batch_stats"], reg))
    return model


_FORWARDS = {}


def _forward(variant):
    """(JAX outputs, port outputs) of one eval-mode forward at B=2."""
    if variant not in _FORWARDS:
        jmodel, model, _ = _models(variant)
        args = _inputs(np.random.RandomState(808), 2, S)
        variables = random_jax_variables(jmodel, args, 1)
        ref = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=False))(
            variables, *args)
        _load(model, variables).eval()
        x_reg, x_root, k_value, K = args
        with torch.no_grad():
            out = model(_nchw(x_reg), _nchw(x_root),
                        torch.from_numpy(k_value), torch.from_numpy(K))
        _FORWARDS[variant] = ({k: np.asarray(v) for k, v in ref.items()},
                              {k: v.numpy() for k, v in out.items()})
    return _FORWARDS[variant]


@pytest.mark.parametrize("variant,key", FORWARD_CASES)
def test_variant_forward_matches_jax(variant, key):
    ref, out = _forward(variant)
    assert sorted(out) == sorted(ref)
    assert out[key].shape == ref[key].shape
    assert np.isfinite(out[key]).all()
    assert rel_err(out[key], ref[key]) <= REL_TOL, key


def test_variant_state_dicts_hold_the_reference_names():
    """Each flag's modules under the reference checkpoints' keys, and no
    head the flag replaces."""
    _, v1, _ = _models("v1")
    _, v2, _ = _models("v2")
    k1, k2 = set(v1.state_dict()), set(v2.state_dict())
    assert {"joint_conv_layers.0.weight", "joint_conv_layers.7.running_var",
            "joint_final_layer.bias", "depth_fc_d1.weight",
            "depth_fc_u2.bias", "depth_bn.running_mean"} <= k1
    assert not any(k.startswith(("fc_pose", "decpose")) for k in k1)
    assert v1.depth_layer.weight.shape[0] == 7
    assert {f"fc_rot_{i}.weight" for i in range(1, 7)} <= k2
    assert v2.fc_rot_1.weight.shape[1] == 2048
    assert v2.decrot.weight.shape[0] == 4
    assert tuple(v2.init_rot.tolist()) == (1.0, 0.0, 0.0, 0.0)


def test_rotation_dim_9_fails_in_both_packages():
    """build_fullnet gives 6 init_rot values for every rotation_dim but 4:
    the JAX model cannot broadcast them to (B, 9), and the port says so
    when it is built."""
    jcfg, cfg = _cfgs(rotation_dim=9)
    args = _inputs(np.random.RandomState(0), 1, S)
    with pytest.raises((ValueError, TypeError)):
        jax.eval_shape(lambda: jax_build_fullnet(jcfg).init(
            jax.random.PRNGKey(0), *args, train=False))
    with pytest.raises(ValueError, match="init_rot"):
        build_fullnet(cfg)


def test_rot_iterative_matmul_needs_6d_rotations():
    _, cfg = _cfgs(rot_iterative_matmul=True, rotation_dim=4)
    with pytest.raises(ValueError, match="rot_iterative_matmul"):
        build_fullnet(cfg)


def test_config_reads_the_variant_flags():
    """FullNetConfig.from_cfg reads the flags as the JAX config holds
    them, build_fullnet takes the keypoints as ints, and an empty
    joint_conv_dim builds the JAX package's (256, 256, 256)."""
    jcfg, _ = _cfgs(reg_joint_map=True, multi_kp=True,
                    kps_need_depth=[1, 3.0], joint_conv_dim=[])
    cfg = FullNetConfig.from_cfg(jcfg)
    assert cfg.reg_joint_map and cfg.multi_kp
    assert cfg.kps_need_depth == [1, 3.0] and cfg.joint_conv_dim == []
    model = build_fullnet(cfg)
    assert model.kps_need_depth == (1, 3) and model.root_depth_index == 1
    widths = [m.out_channels for m in model.joint_conv_layers
              if isinstance(m, torch.nn.Conv2d)]
    assert widths == [256, 256, 256]
    np.testing.assert_allclose(model.joint_bounds.numpy(),
                               JC.JOINT_BOUNDS["panda"])


# ---- rotations ----

def _rotations(rng, n):
    """Random rotations, and rotations within 1e-3 rad of 180 degrees
    about random axes, where the trace form loses w."""
    axes = rng.randn(2 * n, 3)
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angles = np.concatenate([rng.uniform(0, np.pi, n),
                             np.pi - rng.uniform(0, 1e-3, n)])
    aa = (axes * angles[:, None]).astype(np.float32)
    return np.asarray(JR.axis_angle_to_rotmat(jnp.asarray(aa)))


@pytest.mark.parametrize("fn", ["rotmat_to_quat", "rotmat_to_quat_trace"])
def test_quaternion_maps_match_jax(fn, rng):
    R = _rotations(rng, 64)
    ref = np.asarray(getattr(JR, fn)(jnp.asarray(R)))
    out = getattr(TR, fn)(torch.tensor(R)).numpy()
    np.testing.assert_allclose(out, ref, atol=F32_TOL, rtol=0)
    if fn == "rotmat_to_quat":
        assert (out[:, 0] >= 0).all()            # the w >= 0 convention
        back = TR.quat_to_rotmat(torch.from_numpy(out)).numpy()
        np.testing.assert_allclose(back, R, atol=1e-5)


def test_rot9d_to_rotmat_matches_jax(rng):
    r9 = rng.randn(32, 9).astype(np.float32)
    ref = np.asarray(JR.rot9d_to_rotmat(jnp.asarray(r9)))
    out = TR.rot9d_to_rotmat(torch.from_numpy(r9)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.det(out), 1.0, atol=1e-5)


@pytest.mark.parametrize("dim", [4, 6, 9])
def test_rotation_dispatch_round_trips(dim, rng):
    R = _rotations(rng, 8)
    out = TR.rot_to_rotmat(TR.rotmat_to_rot(torch.tensor(R), dim))
    np.testing.assert_allclose(out.numpy(), R, atol=2e-5)


def test_normalize_vector_matches_jax(rng):
    v = rng.randn(16, 3).astype(np.float32)
    v[0] = 0.0                                   # the magnitude floor
    np.testing.assert_allclose(
        TR.normalize_vector(torch.from_numpy(v)).numpy(),
        np.asarray(JR.normalize_vector(jnp.asarray(v))), atol=F32_TOL)


# ---- ground truth and losses ----

@pytest.fixture(scope="module")
def np_batch(tmp_path_factory):
    d = make_synthetic_dream_dataset(tmp_path_factory.mktemp("ds") / "dream",
                                     "panda", n_images=B, split="train_dr",
                                     seed=37)
    ds = DreamDataset(d, color_jitter=False, rgb_augmentation=False,
                      occlusion_augmentation=False,
                      rootnet_resize_hw=(S, S), other_resize_hw=(S, S))
    loader = DataLoader(ds, batch_size=B, num_workers=0, drop_last=False)
    batch = next(iter(loader))
    loader.close()
    return batch


@pytest.fixture(scope="module")
def robots():
    return JaxRobot("panda"), Robot("panda", device="cpu")


@pytest.mark.parametrize("ref_kp", [0, 3])
def test_prepare_gt_quaternion_matches_jax(ref_kp, np_batch, robots):
    jcfg, cfg = _cfgs(rotation_dim=4, reference_keypoint_id=ref_kp)
    ref = JE.prepare_gt(jcfg, robots[0], jax.tree.map(jnp.asarray, np_batch))
    out = TE.prepare_gt(cfg, robots[1], TE.batch_to_torch(np_batch, "cpu"))
    assert sorted(out) == sorted(ref)
    assert out["gt_rot"].shape == (B, 4) and out["gt_root_rot"].shape == (B, 4)
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=F32_TOL, atol=F32_TOL, err_msg=k)


@pytest.mark.parametrize("row_mask", [False, True])
@pytest.mark.parametrize("kps", [(0, 1, 2, 3, 4, 5, 6), (3, 5)])
def test_multi_kp_loss_matches_jax(kps, row_mask, np_batch, robots, rng):
    """The L1 on the chosen keypoints' depths enters the sum, not the
    named losses."""
    jcfg, cfg = _cfgs(multi_kp=True, kps_need_depth=list(kps))
    kp = rng.randn(B, 7, 3) * 0.2 + [0, 0, 1.5]
    preds = {k: v.astype(np.float32) for k, v in dict(
        pose=rng.randn(B, 8), rot=rng.randn(B, 6),
        trans=rng.randn(B, 3) * 0.3, root_uv=rng.uniform(0, S, (B, 2)),
        depth=rng.uniform(0.5, 2, (B, 1)), xyz_int=kp,
        xyz_fk=kp + rng.randn(B, 7, 3) * 0.05,
        depths=rng.uniform(0.5, 2, (B, len(kps)))).items()}
    rm = np.asarray([1, 1, 1, 0], np.float32) if row_mask else None
    jb = jax.tree.map(jnp.asarray, np_batch)
    ref, ref_dict = JE.compute_full_losses(
        jcfg, {k: jnp.asarray(v) for k, v in preds.items()},
        JE.prepare_gt(jcfg, robots[0], jb), jb["other"]["K"],
        row_mask=None if rm is None else jnp.asarray(rm))
    tb = TE.batch_to_torch(np_batch, "cpu")
    out, out_dict = TE.compute_full_losses(
        cfg, {k: torch.from_numpy(v) for k, v in preds.items()},
        TE.prepare_gt(cfg, robots[1], tb), tb["other"]["K"],
        row_mask=None if rm is None else torch.from_numpy(rm))
    assert sorted(out_dict) == sorted(ref_dict)
    np.testing.assert_allclose(float(out), float(ref), rtol=F32_TOL)
    _, cfg0 = _cfgs()
    plain, _ = TE.compute_full_losses(
        cfg0, {k: torch.from_numpy(v) for k, v in preds.items()},
        TE.prepare_gt(cfg0, robots[1], tb), tb["other"]["K"],
        row_mask=None if rm is None else torch.from_numpy(rm))
    assert float(out) > float(plain)


# ---- the V1 train step ----

def _conditioned_variables(jmodel, np_batch, jcfg, robot):
    """Random V1 weights, conditioned as the flagship step test's: the
    last BatchNorm scale of each residual branch x0.1, and a depth head
    that predicts about the batch's own depth of every keypoint."""
    args = (np.zeros((1, S, S, 3), np.float32),
            np.zeros((1, S, S, 3), np.float32), np.ones((1,), np.float32),
            np.eye(3, dtype=np.float32)[None])
    variables = random_jax_variables(jmodel, args, seed=11)
    gts = JE.prepare_gt(jcfg, robot, jax.tree.map(jnp.asarray, np_batch))
    depths = np.asarray(gts["gt_keypoints3d"])[:, :, 2]
    gamma = np.mean(depths * 1000.0 /
                    np.asarray(gts["k_values"])[:, None], axis=0)
    for backbone in ("reg_backbone", "rootnet_backbone"):
        for name, block in variables["params"][backbone].items():
            if name.startswith("layer"):       # resnet18 basic blocks
                block["BatchNorm_1"]["scale"] = block["BatchNorm_1"][
                    "scale"] * 0.1
    head = variables["params"]["depth_layer"]
    head["kernel"] = head["kernel"] * 1e-3
    head["bias"] = gamma.astype(np.float32)
    return variables


@pytest.fixture(scope="module")
def v1_train_step(np_batch, robots):
    reg = "resnet18"
    jmodel, model, cfg = _models("v1", reg)
    jcfg, _ = _cfgs(reg, **VARIANTS["v1"])
    variables = _conditioned_variables(jmodel, np_batch, jcfg, robots[0])
    tx = JE.make_optimizer(jcfg, 1)
    step = JE.build_full_train_step(jcfg, jmodel, robots[0], _recording(tx))
    state = JE.create_train_state(variables, _recording(tx))
    new_state, jlogs = step(state, jax.tree.map(jnp.asarray, np_batch),
                            jax.random.PRNGKey(0))
    jgrads = _to_torch(new_state.opt_state[1], new_state.batch_stats, reg)

    _load(model, variables, reg)
    opt, sched = TE.make_optimizer(cfg, model.parameters(), 1)
    grads = {}
    clip = TE.clip_by_global_norm_

    def catching_clip(params, max_norm):
        grads.update({k: p.grad.clone()
                      for k, p in model.named_parameters()})
        return clip(params, max_norm)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TE, "clip_by_global_norm_", catching_clip)
        logs = TE.build_full_train_step(cfg, model, robots[1], opt, sched)(
            TE.batch_to_torch(np_batch, "cpu"), None)
    return dict(jlogs={k: float(v) for k, v in jlogs.items()},
                logs={k: float(v) for k, v in logs.items()},
                grads=grads, jgrads=jgrads)


def test_v1_train_step_losses_match_jax(v1_train_step):
    logs, jlogs = v1_train_step["logs"], v1_train_step["jlogs"]
    assert sorted(logs) == sorted(jlogs)
    for k, ref in jlogs.items():
        assert np.isfinite(logs[k]), k
        assert abs(logs[k] - ref) / max(abs(ref), 1e-3) <= LOSS_REL, \
            (k, logs[k], ref)


def test_v1_train_step_gradients_match_jax(v1_train_step):
    grads, jgrads = v1_train_step["grads"], v1_train_step["jgrads"]
    assert {"joint_final_layer.weight", "depth_fc_d1.weight",
            "depth_bn.weight", "depth_layer.weight"} <= set(grads)
    a = np.concatenate([grads[k].double().numpy().ravel() for k in grads])
    b = np.concatenate([jgrads[k].double().numpy().ravel() for k in grads])
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    print(f"V1 train step: gradient cosine {cos:.8f}")
    assert cos >= GRAD_COSINE
    # the variant heads' own leaves
    for k in ("joint_final_layer.weight", "depth_fc_u1.weight",
              "depth_layer.weight", "decrot.weight"):
        g, j = grads[k].numpy(), jgrads[k].numpy()
        assert np.linalg.norm(g - j) <= 1e-3 * np.linalg.norm(j), k
