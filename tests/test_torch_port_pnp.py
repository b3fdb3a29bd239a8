"""Port PnP (`horopose_tpu_torch/ops/pnp.py`) against the JAX package, on
the CPU: the axis-angle maps, the solver on general and coplanar point
sets with 0.5 px noise, the refine's analytic Jacobian against autograd,
its implicit-function backward against `jax.grad`, `batch_project`, and the PnP pseudo-ground truth of
`prepare_gt` on a real-set batch read from files the JAX writer made; the
test harness on a real-named set, from an experiment the JAX package
wrote."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from horopose_tpu.config import make_cfg as jax_make_cfg
from horopose_tpu.core import engine as JE
from horopose_tpu.core.checkpoint import \
    save_checkpoint_file as jax_save_checkpoint
from horopose_tpu.kinematics import Robot as JaxRobot
from horopose_tpu.ops.pnp import batch_project as jax_batch_project
from horopose_tpu.ops.pnp import pnp as jax_pnp
from horopose_tpu.ops.pnp import pnp_theta as jax_pnp_theta
from horopose_tpu.ops import rotations as JR
from horopose_tpu.pipelines.common import build_fullnet as jax_build_fullnet
from horopose_tpu_torch.config import make_cfg
from horopose_tpu_torch.core import engine as TE
from horopose_tpu_torch.data.dream import DreamDataset
from horopose_tpu_torch.data.samplers import collate
from horopose_tpu_torch.kinematics import Robot
from horopose_tpu_torch.ops import pnp as P
from horopose_tpu_torch.ops import rotations as R
from horopose_tpu_torch.pipelines.common import make_pnp_fn
from horopose_tpu_torch.pipelines import test as harness

from fixtures import make_synthetic_dream_dataset
from test_torch_port_models import random_jax_variables

POSE_ATOL = 1e-4        # R entries and t (metres) against the JAX solver
GRAD_REL = 1e-3         # the implicit backward, L2 over each input
B, N = 6, 7


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(seed, coplanar):
    """B posed sets of N points 1-2 m in front of a 640x480 camera, their
    projections with 0.5 px noise; coplanar puts the points on z = 0."""
    rng = np.random.RandomState(seed)
    aa = rng.normal(size=(B, 3)) * 0.5
    Rm = np.asarray(JR.axis_angle_to_rotmat(jnp.asarray(aa)), np.float64)
    t = np.stack([rng.uniform(-0.2, 0.2, B), rng.uniform(-0.2, 0.2, B),
                  rng.uniform(1.0, 2.0, B)], 1)
    X = rng.uniform(-0.4, 0.4, (B, N, 3))
    if coplanar:
        X[..., 2] = 0.0
    K = np.tile(np.array([[600.0, 0, 320], [0, 610.0, 240], [0, 0, 1]]),
                (B, 1, 1))
    cam = np.einsum("bij,bnj->bni", Rm, X) + t[:, None]
    uv = np.einsum("bij,bnj->bni", K, cam)
    uv = uv[..., :2] / uv[..., 2:3] + rng.normal(size=(B, N, 2)) * 0.5
    return [a.astype(np.float32) for a in (uv, X, K)]


def test_axis_angle_maps_match_jax(rng):
    aa = np.concatenate([rng.normal(size=(8, 3)),
                         rng.normal(size=(2, 3)) * 1e-4]).astype(np.float32)
    Rm = R.axis_angle_to_rotmat(torch.from_numpy(aa))
    np.testing.assert_allclose(
        Rm.numpy(), np.asarray(JR.axis_angle_to_rotmat(jnp.asarray(aa))),
        atol=1e-6)
    np.testing.assert_allclose(
        R.rotmat_to_axis_angle(Rm).numpy(),
        np.asarray(JR.rotmat_to_axis_angle(jnp.asarray(Rm.numpy()))),
        atol=1e-5)


@pytest.mark.parametrize("coplanar", [False, True],
                         ids=["general", "coplanar"])
def test_pnp_matches_jax(coplanar):
    uv, X, K = _scene(1 + coplanar, coplanar)
    Rj, tj = jax_pnp(jnp.asarray(uv), jnp.asarray(X), jnp.asarray(K))
    Rt, tt = P.pnp(torch.from_numpy(uv), torch.from_numpy(X),
                   torch.from_numpy(K))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=POSE_ATOL)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=POSE_ATOL)
    # both land on the noisy optimum: reprojection about the noise level
    theta = torch.cat([R.rotmat_to_axis_angle(Rt), tt], -1)
    res = P.batch_project(theta, torch.from_numpy(X), torch.from_numpy(K))
    assert float((res - torch.from_numpy(uv)).norm(dim=-1).max()) < 3.0


def test_pnp_takes_one_intrinsics_for_the_batch():
    uv, X, K = _scene(3, False)
    Rb, tb = P.pnp(torch.from_numpy(uv), torch.from_numpy(X),
                   torch.from_numpy(K))
    R1, t1 = P.pnp(torch.from_numpy(uv), torch.from_numpy(X),
                   torch.from_numpy(K[0]))
    assert torch.equal(Rb, R1) and torch.equal(tb, t1)


def test_batch_project_matches_jax(rng):
    theta = np.concatenate([rng.normal(size=(B, 3)) * 0.3,
                            rng.uniform(1, 2, (B, 3))], 1).astype(np.float32)
    _, X, K = _scene(4, False)
    out = P.batch_project(torch.from_numpy(theta), torch.from_numpy(X),
                          torch.from_numpy(K))
    ref = jax_batch_project(jnp.asarray(theta), jnp.asarray(X), jnp.asarray(K))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-3)


@pytest.mark.parametrize("seed", [5, 7])
def test_implicit_backward_matches_jax_grad(seed):
    """The implicit backward against jax.grad, through R and t: the
    axis-angle theta of `pnp_theta` is one of two representations of R
    where |theta| crosses pi, and which one an LM path ends on depends on
    its rounding, while R, t and their gradients do not."""
    uv, X, K = _scene(seed, False)
    rng = np.random.RandomState(seed + 1)
    wR = rng.normal(size=(B, 3, 3)).astype(np.float32)
    wt = rng.normal(size=(B, 3)).astype(np.float32)

    def jloss(*a):
        Rj, tj = jax_pnp(*a)
        return jnp.sum(Rj * wR) + jnp.sum(tj * wt)

    ref = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(uv), jnp.asarray(X),
                                            jnp.asarray(K))
    ins = [torch.from_numpy(a).requires_grad_() for a in (uv, X, K)]
    Rt, tt = P.pnp(*ins)
    ((Rt * torch.from_numpy(wR)).sum()
     + (tt * torch.from_numpy(wt)).sum()).backward()
    for name, a, r in zip(("pts2d", "pts3d", "K"), ins, ref):
        r = np.asarray(r)
        rel = np.linalg.norm(a.grad.numpy() - r) / np.linalg.norm(r)
        assert rel <= GRAD_REL, (name, rel)


def test_refine_jacobian_matches_autograd():
    """The LM refine's analytic Jacobian against autograd of its residual,
    a near-zero rotation (the first-order branch) included."""
    g = torch.Generator().manual_seed(0)
    theta = torch.randn(5, 6, generator=g)
    theta[:, 3:] = theta[:, 3:] * 0.2 + torch.tensor([0.0, 0.0, 2.0])
    theta[0, :3] = 1e-4
    theta[1, :3] *= 3.0
    uvn = torch.randn(5, N, 2, generator=g) * 0.2
    Xc = torch.randn(5, N, 3, generator=g) * 0.3
    f = torch.rand(5, 2, generator=g) * 500 + 300
    r, J = P._residuals_and_jacobian(theta, uvn, Xc, f)
    torch.testing.assert_close(r, P._residuals_n(theta, uvn, Xc, f))
    for b in range(5):
        ref = torch.autograd.functional.jacobian(
            lambda t: P._residuals_n(t[None], uvn[b:b + 1], Xc[b:b + 1],
                                     f[b:b + 1])[0], theta[b])
        torch.testing.assert_close(J[b], ref, rtol=1e-5,
                                   atol=1e-6 * float(ref.abs().max()))


def test_make_pnp_fn_keys_on_the_set_name():
    assert make_pnp_fn("/data/dream/synthetic/panda_synth_train_dr") is None
    assert make_pnp_fn("/data/dream/real/panda-3cam_azure") is P.pnp


@pytest.fixture(scope="module")
def real_set(tmp_path_factory):
    return make_synthetic_dream_dataset(
        tmp_path_factory.mktemp("real") / "dream", "panda", n_images=4,
        synthetic=False, split="azure", seed=11)


def _gt_cfgs(**overrides):
    jcfg = jax_make_cfg(os.path.join(os.path.dirname(__file__), "..",
                                     "configs", "panda", "full.yaml"))
    cfg = make_cfg(os.path.join(os.path.dirname(__file__), "..",
                                "configs", "panda", "full.yaml"))
    for c in (jcfg, cfg):
        c.update(overrides)
    return jcfg, cfg


@pytest.mark.parametrize("ref_kp", [0, 3])
def test_prepare_gt_with_pnp_matches_jax(real_set, ref_kp):
    """The real set's rotation ground truth: PnP of keypoints_2d_original
    against FK world points at K_original, in both packages."""
    ds = DreamDataset(real_set, color_jitter=False, rgb_augmentation=False,
                      occlusion_augmentation=False,
                      rootnet_resize_hw=(64, 64), other_resize_hw=(64, 64))
    batch = collate([ds[i] for i in range(len(ds))])
    jcfg, cfg = _gt_cfgs(reference_keypoint_id=ref_kp)
    np_batch = jax.tree.map(lambda t: t.numpy(), batch)
    ref = JE.prepare_gt(jcfg, JaxRobot("panda"),
                        jax.tree.map(jnp.asarray, np_batch), pnp_fn=jax_pnp)
    out = TE.prepare_gt(cfg, Robot("panda", device="cpu"), batch,
                        pnp_fn=P.pnp)
    for k in ("gt_rot", "gt_root_rot"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=POSE_ATOL, err_msg=k)
    # PnP recovers the set's own rotation from its annotations
    np.testing.assert_allclose(out["gt_rot"].numpy(),
                               TE.rotmat_to_rot6d(
                                   batch["TCO"][:, :3, :3]).numpy(),
                               atol=1e-2)


def test_test_network_on_a_real_set_from_a_jax_experiment(real_set, tmp_path):
    """`test_network` evaluates a real-named set (PnP ground truth) from an
    experiment directory the JAX package wrote: its config.yaml and its
    flax msgpack checkpoint."""
    exp = tmp_path / "exp"
    (exp / "ckpt").mkdir(parents=True)
    cfg_yaml = dict(urdf_robot_name="panda", image_size=64.0,
                    backbone_name="resnet18", rootnet_backbone_name="resnet18",
                    reference_keypoint_id=3)
    (exp / "config.yaml").write_text(yaml.safe_dump(cfg_yaml))
    jcfg = jax_make_cfg(str(exp / "config.yaml"))
    model = jax_build_fullnet(jcfg)
    args = (np.zeros((1, 64, 64, 3), np.float32),
            np.zeros((1, 64, 64, 3), np.float32), np.ones((1,), np.float32),
            np.eye(3, dtype=np.float32)[None])
    state = JE.create_train_state(random_jax_variables(model, args, 9),
                                  JE.make_optimizer(jcfg, 1))
    jax_save_checkpoint(str(exp / "ckpt" / "best.pk"), epoch=4, metric=0.3,
                        state=state)
    cfg = harness.make_test_cfg(str(exp), str(real_set))
    summary = harness.test_network(cfg, ckpt_name="best.pk", batch_size=2,
                                   device="cpu")
    assert np.isfinite(summary["ADD/AUC"])
    text = (exp / "result" / "summary.txt").read_text()
    assert "This model was saved from epoch:4" in text
    assert f"Dataset for testing: {real_set}" in text
