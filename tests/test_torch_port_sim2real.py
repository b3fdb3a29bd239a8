"""Port stage 3 (sim2real) against the JAX package, on the CPU: the robot
meshes, the dense and tiled rasterizers with their gradients, the robot
silhouette, the segmentation teacher and CtRNetInference, frozen
BatchNorm, one sim2real train step for each mask loss, and
`train_sim2real` end to end (as tests/test_sim2real.py runs the JAX one).

The JAX sim2real step freezes BatchNorm only when its first call, which
traces it, runs inside `frozen_batchnorm()`: `build_sim2real_train_step`
leaves that context before returning the jitted step. The step parity
here traces it inside the context, the reference's behaviour (BN frozen),
which the port implements.
"""

import glob
import json
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
from horopose_tpu.kinematics.meshes import \
    build_robot_mesh as jax_build_robot_mesh
from horopose_tpu.models.common import frozen_batchnorm
from horopose_tpu.models.deeplab import CtRNetInference as JaxCtRNet
from horopose_tpu.models.deeplab import KeypointSegNet as JaxSegNet
from horopose_tpu.models.deeplab import SegTeacher as JaxSegTeacher
from horopose_tpu.ops import rasterizer as JR
from horopose_tpu.pipelines.common import build_fullnet as jax_build_fullnet
from horopose_tpu.pipelines.train_sim2real import \
    build_sim2real_train_step as jax_sim2real_step
from horopose_tpu_torch import constants as C
from horopose_tpu_torch.config import make_cfg
from horopose_tpu_torch.core import engine as TE
from horopose_tpu_torch.core.checkpoint import save_checkpoint_file
from horopose_tpu_torch.data.synthetic import synthetic_dream_batch
from horopose_tpu_torch.kinematics import Robot
from horopose_tpu_torch.kinematics.meshes import (build_robot_mesh,
                                                  check_mesh_fidelity)
from horopose_tpu_torch.models.common import train_with_frozen_batchnorm
from horopose_tpu_torch.models.deeplab import CtRNetInference, SegTeacher
from horopose_tpu_torch.ops import rasterizer as R
from horopose_tpu_torch.pipelines import train_sim2real as S
from horopose_tpu_torch.pipelines.common import FullNetConfig
from horopose_tpu_torch.pipelines.train_full import seeded_fullnet
from horopose_tpu_torch.scripts import train as train_cli
from horopose_tpu_torch.tools.jax_weights import (
    fullnet_state_dict_from_jax, seg_teacher_state_dict_from_jax)

from fixtures import make_synthetic_dream_dataset
from test_torch_port_engine import _recording
from test_torch_port_models import random_jax_variables

ALPHA_ATOL = 1e-5       # silhouette alpha against the JAX renderer
VERT_GRAD_REL = 1e-4    # d(weighted alpha) / d(vertices), L2
MASK_ATOL = 1e-5        # teacher masks
KP_ATOL = 1e-4          # teacher keypoints, pixels
POSE_ATOL = 1e-4        # CtRNetInference's R and t
LOSS_REL = 1e-4         # the sim2real step's loss dict
PARAM_REL = 1e-4        # parameters after one step
GRAD_COSINE = 0.99999   # the step's raw gradients
GRAD_L2_REL = 1e-3      # the step's raw gradients, leaf by leaf (L2)
S_IMG = 64              # FullNet crops of the step test
FRAME_HW = (48, 64)     # full frames of the step test; the teacher halves


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _link_index(robot):
    return {n: i for i, n in enumerate(robot.plan.link_names)}


@pytest.fixture(scope="module")
def robots():
    return JaxRobot("panda"), Robot("panda", device="cpu")


@pytest.fixture(scope="module")
def meshes(robots):
    jr, r = robots
    return (jax_build_robot_mesh(jr.model, _link_index(jr)),
            build_robot_mesh(r.model, _link_index(r)))


# ---- meshes ----

@pytest.mark.parametrize("robot", ["panda", "kuka", "baxter"])
def test_robot_mesh_matches_jax(robot):
    jr, r = JaxRobot(robot), Robot(robot, device="cpu")
    ref = jax_build_robot_mesh(jr.model, _link_index(jr))
    out = build_robot_mesh(r.model, _link_index(r))
    np.testing.assert_array_equal(out.verts, ref.verts)
    np.testing.assert_array_equal(out.faces, ref.faces)
    np.testing.assert_array_equal(out.vert_link, ref.vert_link)
    assert (out.n_file_geoms, out.n_primitive_geoms) == \
        (ref.n_file_geoms, ref.n_primitive_geoms)
    check_mesh_fidelity(out)           # primitives only: a warning


def test_mesh_fidelity_rejects_missing_meshes(meshes):
    import dataclasses
    bad = dataclasses.replace(meshes[1], missing_meshes=("link0.obj",))
    with pytest.raises(RuntimeError, match="link0.obj"):
        check_mesh_fidelity(bad)


# ---- the rasterizer ----

def _scene(meshes, seed, hw=(48, 64)):
    """The panda's link meshes at rest, seen upright from the side 1.2 m
    away, two jittered copies."""
    rng = np.random.RandomState(seed)
    upright = np.array([[1.0, 0, 0], [0, 0, -1.0], [0, 1.0, 0]])
    verts = meshes[0].verts[None].repeat(2, 0) @ upright.T \
        + np.array([0, 0.3, 1.2]) + rng.normal(size=(2, 1, 3)) * 0.05
    K = np.array([[120.0, 0, hw[1] / 2], [0, 120.0, hw[0] / 2], [0, 0, 1]],
                 np.float32)
    w = rng.normal(size=(2, *hw)).astype(np.float32)
    return verts.astype(np.float32), meshes[0].faces, K, w


def _vert_grad_rel(fn_j, fn_t, verts, w):
    gj = np.asarray(jax.grad(lambda v: jnp.sum(fn_j(v) * w))(
        jnp.asarray(verts)))
    v = torch.from_numpy(verts).requires_grad_()
    (fn_t(v) * torch.from_numpy(w)).sum().backward()
    return np.linalg.norm(v.grad.numpy() - gj) / np.linalg.norm(gj)


def test_dense_rasterizer_matches_jax(meshes):
    verts, faces, K, w = _scene(meshes, 0)
    hw = w.shape[1:]
    ref = JR.rasterize_silhouette(jnp.asarray(verts), faces, jnp.asarray(K),
                                  hw)
    out = R.rasterize_silhouette(torch.from_numpy(verts),
                                 torch.from_numpy(faces), torch.from_numpy(K),
                                 hw, pixel_chunk=512)
    assert 0.02 < float(out.mean()) < 0.9
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ALPHA_ATOL)
    rel = _vert_grad_rel(
        lambda v: JR.rasterize_silhouette(v, faces, jnp.asarray(K), hw),
        lambda v: R.rasterize_silhouette(v, torch.from_numpy(faces),
                                         torch.from_numpy(K), hw,
                                         pixel_chunk=512), verts, w)
    assert rel <= VERT_GRAD_REL, rel


def test_tiled_rasterizer_matches_jax(meshes):
    """A budget of every face: no tile overflows, so the face sets are
    exact whatever order top-k breaks ties in. Alpha and the gradients
    agree with the JAX renderer, and alpha with the dense one."""
    verts, faces, K, w = _scene(meshes, 1)
    hw = w.shape[1:]
    ref, ref_ov = JR.rasterize_silhouette_tiled(
        jnp.asarray(verts), faces, jnp.asarray(K), hw, faces_per_tile=1024,
        return_overflow=True)
    out, ov = R.rasterize_silhouette_tiled(
        torch.from_numpy(verts), torch.from_numpy(faces), torch.from_numpy(K),
        hw, faces_per_tile=1024, return_overflow=True)
    assert float(ov) == float(ref_ov) == 0.0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ALPHA_ATOL)
    dense = R.rasterize_silhouette(torch.from_numpy(verts),
                                   torch.from_numpy(faces),
                                   torch.from_numpy(K), hw)
    np.testing.assert_allclose(out.numpy(), dense.numpy(), atol=ALPHA_ATOL)
    rel = _vert_grad_rel(
        lambda v: JR.rasterize_silhouette_tiled(
            v, faces, jnp.asarray(K), hw, faces_per_tile=1024),
        lambda v: R.rasterize_silhouette_tiled(
            v, torch.from_numpy(faces), torch.from_numpy(K), hw,
            faces_per_tile=1024), verts, w)
    assert rel <= VERT_GRAD_REL, rel


def _tile_face_counts(verts, faces, K, hw, tile=16, sigma=1.0):
    """Faces whose screen bbox plus the halo overlaps each tile, (B, th,
    tw), counted in numpy."""
    proj = np.einsum("ij,bvj->bvi", K, verts)
    tri = (proj[..., :2] / proj[..., 2:3])[:, faces]
    halo = np.sqrt(37.0 * sigma) + 1.0
    lo, hi = tri.min(2) - halo, tri.max(2) + halo             # (B, F, 2)
    th, tw = -(-hw[0] // tile), -(-hw[1] // tile)
    ty, tx = np.meshgrid(np.arange(th) * tile, np.arange(tw) * tile,
                         indexing="ij")
    ox = (lo[:, None, None, :, 0] <= tx[..., None] + tile) & \
        (hi[:, None, None, :, 0] >= tx[..., None])
    oy = (lo[:, None, None, :, 1] <= ty[..., None] + tile) & \
        (hi[:, None, None, :, 1] >= ty[..., None])
    return (ox & oy).sum(-1)


@pytest.mark.parametrize("budget", [256, 64])
def test_tiled_overflow_matches_jax(meshes, budget):
    """Over budget: the share of overflowing tiles agrees, and so does
    alpha in every tile within the budget (in an overflowing one, a tie at
    the cut may drop another face)."""
    verts, faces, K, w = _scene(meshes, 2)
    hw = w.shape[1:]
    ref, ref_ov = JR.rasterize_silhouette_tiled(
        jnp.asarray(verts), faces, jnp.asarray(K), hw, faces_per_tile=budget,
        return_overflow=True)
    out, ov = R.rasterize_silhouette_tiled(
        torch.from_numpy(verts), torch.from_numpy(faces), torch.from_numpy(K),
        hw, faces_per_tile=budget, return_overflow=True)
    counts = _tile_face_counts(verts, faces, K, hw)
    assert float(ov) == pytest.approx(float(ref_ov)) \
        == pytest.approx(float((counts > budget).mean()))
    assert 0 < float(ov) < 1
    exact = np.repeat(np.repeat(counts <= budget, 16, 1), 16, 2)[
        :, :hw[0], :hw[1]]
    np.testing.assert_allclose(out.numpy()[exact], np.asarray(ref)[exact],
                               atol=ALPHA_ATOL)


@pytest.mark.parametrize("value,n_faces", [
    (None, 548), ("auto", 548), ("auto", 200), ("auto", 7900), (0, 548),
    (128, 548)])
def test_resolve_faces_per_tile_matches_jax(value, n_faces):
    assert R.resolve_faces_per_tile(value, n_faces) == \
        JR.resolve_faces_per_tile(value, n_faces)


@pytest.mark.parametrize("budget", [0, 1024], ids=["dense", "tiled"])
def test_robot_silhouette_matches_jax(robots, meshes, budget):
    """A posed panda placed by its keypoint-3 pose, rendered at the
    teacher's scale; the gradient to the rotation and translation."""
    jr, r = robots
    rng = np.random.RandomState(3)
    pose = (C.initial_joint_vector("mean", "panda")[None]
            + rng.uniform(-0.3, 0.3, (2, 8))).astype(np.float32)
    rot = np.array([[1, 0, 0, 0, 0, -1], [0.9, 0.1, 0, 0, 0.1, -1]],
                   np.float32)
    trans = np.array([[0.05, 0.0, 1.3], [-0.05, 0.05, 1.5]], np.float32)
    K = np.array([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]], np.float32)
    hw = (48, 64)
    w = rng.normal(size=(2, *hw)).astype(np.float32)

    def jfn(rot_, trans_):
        return JR.render_robot_silhouette(
            jr, meshes[0], jnp.asarray(pose), rot_, trans_, jnp.asarray(K),
            hw, root=3, faces_per_tile=budget)

    ref = jfn(jnp.asarray(rot), jnp.asarray(trans))
    jg = jax.grad(lambda a, b: jnp.sum(jfn(a, b) * w), argnums=(0, 1))(
        jnp.asarray(rot), jnp.asarray(trans))
    rot_t = torch.from_numpy(rot).requires_grad_()
    trans_t = torch.from_numpy(trans).requires_grad_()
    out, ov = R.render_robot_silhouette(
        r, meshes[1], torch.from_numpy(pose), rot_t, trans_t,
        torch.from_numpy(K), hw, root=3, faces_per_tile=budget,
        return_overflow=True)
    assert float(ov) == 0.0 and float(out.detach().mean()) > 0.01
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=ALPHA_ATOL)
    (out * torch.from_numpy(w)).sum().backward()
    for g, ref_g in ((rot_t.grad, jg[0]), (trans_t.grad, jg[1])):
        ref_g = np.asarray(ref_g)
        assert np.linalg.norm(g.numpy() - ref_g) / np.linalg.norm(ref_g) \
            <= VERT_GRAD_REL


# ---- the segmentation teacher ----

@pytest.fixture(scope="module")
def teachers():
    """The JAX teacher and the port's on the same numpy-random weights,
    48x64 frames halved to 24x32."""
    variables = random_jax_variables(JaxSegNet(),
                                     (jnp.zeros((1, 24, 32, 3)),), seed=1)
    jt = JaxSegTeacher(variables, image_hw=FRAME_HW, scale=0.5)
    t = SegTeacher(image_hw=FRAME_HW, scale=0.5)
    t.model.load_state_dict(seg_teacher_state_dict_from_jax(
        variables["params"], variables["batch_stats"]))
    return jt, t, variables


def test_seg_teacher_matches_jax(teachers):
    jt, t, _ = teachers
    images = np.random.RandomState(4).randint(0, 256, (2, *FRAME_HW, 3),
                                              dtype=np.uint8)
    masks = t(torch.from_numpy(images))
    assert masks.shape == (2, 24, 32) and t.out_hw == jt.out_hw
    np.testing.assert_allclose(masks.numpy(),
                               np.asarray(jt(jnp.asarray(images))),
                               atol=MASK_ATOL)
    # the network itself on the same normalised input: keypoints and the
    # upsampled logits, edges included
    x = t.normalize(torch.from_numpy(images))
    kp_j, seg_j = jt.model.apply(jt.variables,
                                 jnp.asarray(x.permute(0, 2, 3, 1).numpy()),
                                 train=False)
    with torch.no_grad():
        kp, seg = t.model(x)
    np.testing.assert_allclose(kp.numpy(), np.asarray(kp_j), atol=KP_ATOL)
    np.testing.assert_allclose(seg[:, 0].numpy(), np.asarray(seg_j)[..., 0],
                               atol=MASK_ATOL)


def test_seg_teacher_resize_antialiases_as_jax():
    """480x640 -> 240x320: jax.image.resize antialiases a downsample."""
    t = SegTeacher()
    images = np.random.RandomState(5).randint(0, 256, (1, 480, 640, 3),
                                              dtype=np.uint8)
    x = t.normalize(torch.from_numpy(images)) * t.std + t.mean
    ref = jax.image.resize(jnp.asarray(images, jnp.float32) / 255.0,
                           (1, 240, 320, 3), "bilinear")
    np.testing.assert_allclose(x.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), atol=1e-5)


def test_seg_teacher_map_rejects_a_leftover_leaf(teachers):
    _, _, variables = teachers
    params = dict(variables["params"], extra={"kernel": np.zeros((1, 1))})
    with pytest.raises(ValueError, match="extra/kernel"):
        seg_teacher_state_dict_from_jax(params, variables["batch_stats"])


def test_seg_teacher_stays_frozen():
    t = SegTeacher(image_hw=FRAME_HW)
    t.train()
    assert not t.training and not t.model.training
    assert not any(p.requires_grad for p in t.parameters())


def test_ctrnet_inference_matches_jax(teachers, robots):
    """Masks, full-resolution keypoints and the PnP pose against FK. A
    random teacher's keypoints sit in a clump, where PnP has no unique
    optimum, so both packages' keypoint heads are replaced by the half-
    scale projections (plus 0.1 px noise) of the FK keypoints under a
    known pose; the masks are the real networks'."""
    jt, t, _ = teachers
    jr, r = robots
    rng = np.random.RandomState(6)
    images = rng.randint(0, 256, (2, *FRAME_HW, 3), dtype=np.uint8)
    joints = (C.initial_joint_vector("mean", "panda")[None]
              + rng.uniform(-0.3, 0.3, (2, 8))).astype(np.float32)
    K = np.array([[120.0, 0, 32], [0, 120.0, 24], [0, 0, 1]], np.float32)
    upright = np.array([[1.0, 0, 0], [0, 0, -1.0], [0, 1.0, 0]])
    world = r.get_keypoints_only_fk(torch.from_numpy(joints)).double().numpy()
    cam = world @ upright.T + np.array([0.0, 0.3, 1.5])
    uv = np.einsum("ij,bnj->bni", K, cam)
    kp_half = ((uv[..., :2] / uv[..., 2:3] + rng.normal(size=(2, 7, 2))
                * 0.1) * 0.5).astype(np.float32)

    class JaxHead:
        def apply(self, variables, x, train=False):
            return jnp.asarray(kp_half), jt.model.apply(variables, x,
                                                        train=train)[1]

    class PortHead(torch.nn.Module):
        def __init__(self, net):
            super().__init__()
            self.net = net

        def forward(self, x):
            return torch.from_numpy(kp_half), self.net(x)[1]

    jt_fixed = JaxSegTeacher(jt.variables, image_hw=FRAME_HW, scale=0.5)
    jt_fixed.model = JaxHead()
    t_fixed = SegTeacher(image_hw=FRAME_HW, scale=0.5)
    t_fixed.model = PortHead(t.model)
    masks_j, kp_j, (R_j, t_j) = JaxCtRNet(jt_fixed, jr)(
        jnp.asarray(images), jnp.asarray(joints), jnp.asarray(K))
    masks, kp, (Rm, tv) = CtRNetInference(t_fixed, r)(
        torch.from_numpy(images), torch.from_numpy(joints),
        torch.from_numpy(K))
    np.testing.assert_allclose(masks.numpy(), np.asarray(masks_j),
                               atol=MASK_ATOL)
    np.testing.assert_allclose(kp.numpy(), np.asarray(kp_j), atol=KP_ATOL)
    np.testing.assert_allclose(Rm.numpy(), np.asarray(R_j), atol=POSE_ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(t_j), atol=POSE_ATOL)
    np.testing.assert_allclose(Rm.numpy(), np.tile(upright, (2, 1, 1)),
                               atol=0.05)


# ---- frozen BatchNorm ----

def test_frozen_batchnorm_trains_scale_and_bias_only():
    model = torch.nn.Sequential(torch.nn.Linear(4, 6), torch.nn.Dropout(0.5),
                                torch.nn.BatchNorm1d(6))
    train_with_frozen_batchnorm(model)
    assert model.training and model[1].training and not model[2].training
    before = {k: v.clone() for k, v in model[2].state_dict().items()}
    model(torch.randn(8, 4)).sum().backward()
    for k, v in model[2].state_dict().items():
        assert torch.equal(v, before[k]), k
    assert model[2].weight.grad is not None and model[2].bias.grad is not None


# ---- one sim2real step ----

def _step_yaml(tmp, mask_loss):
    path = tmp / f"s2r_{mask_loss}.yaml"
    path.write_text(yaml.safe_dump(dict(
        exp_name="s2r_step", urdf_robot_name="panda", batch_size=2,
        image_size=float(S_IMG), lr=1e-6, clip_gradient=5.0,
        use_schedule=False, use_sim2real=True, backbone_name="resnet18",
        rootnet_backbone_name="resnet18", mask_loss_func=mask_loss,
        mask_loss_weight=1.0, iou_loss_weight=1.0, scale_loss_weight=0.1,
        align_3d_loss_weight=1.0, reference_keypoint_id=3, p_dropout=0.0,
        raster_faces_per_tile=0)))
    return str(path)


@pytest.fixture(scope="module")
def step_inputs(robots, tmp_path_factory):
    """A batch (48x64 frames, K_original scaled so that the scale loss's
    filter fires on the random model's render) and the FullNet's random
    weights."""
    _, r = robots
    batch = synthetic_dream_batch(r, 2, S_IMG, S_IMG, 5, device="cpu")
    rng = np.random.RandomState(0)
    batch["images_original"] = torch.from_numpy(
        rng.randint(0, 256, (2, *FRAME_HW, 3)).astype(np.uint8))
    K = batch["K_original"] * 0.3
    K[:, 2, 2] = 1.0
    batch["K_original"] = K
    jcfg = jax_make_cfg(_step_yaml(tmp_path_factory.mktemp("step"),
                                   "mse_mean"))
    args = (np.zeros((1, S_IMG, S_IMG, 3), np.float32),
            np.zeros((1, S_IMG, S_IMG, 3), np.float32),
            np.ones((1,), np.float32), np.eye(3, dtype=np.float32)[None])
    variables = random_jax_variables(jax_build_fullnet(jcfg), args, seed=7)
    return batch, variables


def _sd(tree, batch_stats):
    return fullnet_state_dict_from_jax(jax.tree.map(np.array, tree),
                                       jax.tree.map(np.array, batch_stats),
                                       "resnet18", "resnet18")


@pytest.mark.parametrize("mask_loss", ["mse_mean", "bce", "mse_sum"])
def test_sim2real_step_matches_jax(mask_loss, robots, meshes, teachers,
                                   step_inputs, tmp_path):
    jr, r = robots
    jt, t, _ = teachers
    batch, variables = step_inputs
    path = _step_yaml(tmp_path, mask_loss)
    jcfg, cfg = jax_make_cfg(path), make_cfg(path)

    tx = JE.make_optimizer(jcfg, 1)
    jstep = jax_sim2real_step(jcfg, jax_build_fullnet(jcfg), jr, meshes[0],
                              jt, _recording(tx), image_hw=FRAME_HW)
    state = JE.create_train_state(variables, _recording(tx))
    np_batch = jax.tree.map(lambda v: v.numpy(), batch)
    with frozen_batchnorm():        # traced here: BatchNorm frozen
        new, jlogs = jstep(state, jax.tree.map(jnp.asarray, np_batch),
                           jax.random.PRNGKey(0))

    fcfg = FullNetConfig.from_cfg(cfg)
    model = seeded_fullnet(fcfg)
    model.load_state_dict(_sd(variables["params"], variables["batch_stats"]))
    opt, sched = TE.make_optimizer(fcfg, model.parameters(), 1)
    raw = {}
    clip = TE.clip_by_global_norm_

    def catching_clip(params, max_norm):
        raw.update({k: p.grad.clone() for k, p in model.named_parameters()})
        return clip(params, max_norm)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TE, "clip_by_global_norm_", catching_clip)
        logs = S.build_sim2real_train_step(cfg, model, r, meshes[1], t, opt,
                                           sched, image_hw=FRAME_HW)(batch,
                                                                     None)

    assert sorted(logs) == sorted(jlogs)
    assert float(logs["loss_scale"]) > 0       # the filter fired
    for k, ref in jlogs.items():
        out, ref = float(logs[k]), float(ref)
        assert abs(out - ref) <= LOSS_REL * max(abs(ref), 1e-6), (k, out, ref)

    jgrads = _sd(new.opt_state[1], new.batch_stats)
    a = np.concatenate([raw[k].double().numpy().ravel() for k in raw])
    b = np.concatenate([jgrads[k].double().numpy().ravel() for k in raw])
    assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) > GRAD_COSINE
    gnorm = max(float(jgrads[k].norm()) for k in raw)
    for k, g in raw.items():
        ref = jgrads[k].double().numpy()
        assert np.linalg.norm(g.double().numpy() - ref) \
            <= GRAD_L2_REL * max(np.linalg.norm(ref), 1e-3 * gnorm), k

    post, pre = _sd(new.params, new.batch_stats), _sd(
        variables["params"], variables["batch_stats"])
    sd = model.state_dict()
    for k, ref in post.items():
        scale = max(float(ref.abs().max()), 1e-6)
        assert float((sd[k] - ref).abs().max()) <= PARAM_REL * scale, k
        if k.endswith(("running_mean", "running_var")):
            assert torch.equal(sd[k], pre[k]) and torch.equal(ref, pre[k]), k


# ---- train_sim2real end to end ----

@pytest.fixture(scope="module")
def real_ws(tmp_path_factory):
    base = tmp_path_factory.mktemp("s2r")
    train_dir = make_synthetic_dream_dataset(
        base / "dream", "panda", n_images=4, synthetic=False, split="azure",
        seed=3)
    return base, train_dir


def _cfg(base, train_dir, name, **overrides):
    values = dict(
        exp_name=name, urdf_robot_name="panda", batch_size=2, epoch_size=4,
        n_epochs=1, n_dataloader_workers=0, image_size=64.0, lr=1e-6,
        clip_gradient=5.0, use_schedule=False, use_sim2real=True,
        backbone_name="resnet18", rootnet_backbone_name="resnet18",
        mask_loss_func="mse_mean", mask_loss_weight=1.0, iou_loss_weight=1.0,
        scale_loss_weight=0.1, align_3d_loss_weight=1.0,
        reference_keypoint_id=3, allow_random_init=True)
    values.update(overrides)
    path = base / f"{name}.yaml"
    path.write_text(yaml.safe_dump(values))
    cfg = make_cfg(str(path))
    cfg.train_ds_names = str(train_dir)
    # keys the config file does not know (track_worst_n) are set directly
    cfg.update({k: v for k, v in values.items() if k not in cfg})
    return cfg


@pytest.fixture(scope="module")
def small_teacher():
    return SegTeacher.init_random(0, image_hw=(480, 640), scale=0.1)


def _scalars(exp_root, name):
    with open(os.path.join(exp_root, name, "log", "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_sim2real_smoke(real_ws, tmp_path, small_teacher):
    """One epoch: two steps, validation on the real set with PnP, the
    tracked worst views written."""
    base, train_dir = real_ws
    cfg = _cfg(base, train_dir, "s2r_smoke", raster_faces_per_tile=0)
    exp_root = str(tmp_path / "experiments")
    state = S.train_sim2real(cfg, max_epochs=1, seg_teacher=small_teacher,
                             device="cpu", exp_root=exp_root)
    assert int(state.optimizer.state_dict()["state"][0]["step"]) == 2
    tags = {r["tag"]: r["value"] for r in _scalars(exp_root, "s2r_smoke")}
    for t in S.S2R_TAGS:
        assert np.isfinite(tags[f"Train/{t}"]), t
    assert "Val/AUC_ADD_azure" in tags and "Val/rot_diff_azure" in tags
    assert glob.glob(os.path.join(exp_root, "s2r_smoke", "track",
                                  "epoch000_view*.jpg"))


def test_sim2real_tiled_rasterizer_smoke(real_ws, tmp_path, small_teacher):
    base, train_dir = real_ws
    cfg = _cfg(base, train_dir, "s2r_tiled", epoch_size=2,
               raster_faces_per_tile=256, track_worst_n=0)
    exp_root = str(tmp_path / "experiments")
    state = S.train_sim2real(cfg, max_epochs=1, seg_teacher=small_teacher,
                             device="cpu", exp_root=exp_root)
    assert int(state.optimizer.state_dict()["state"][0]["step"]) == 1
    tags = [r["tag"] for r in _scalars(exp_root, "s2r_tiled")]
    assert "Train/cull_overflow" in tags


def test_sim2real_synth_handoff_is_weights_only(real_ws, tmp_path,
                                                small_teacher):
    """The stage-2 -> stage-3 hand-off from a checkpoint the JAX package
    wrote (flax msgpack, a dirty optimizer state): the weights load, Adam
    starts fresh. Without weights and without the debug flag it refuses."""
    base, train_dir = real_ws
    cfg = _cfg(base, train_dir, "s2r_handoff", epoch_size=2,
               allow_random_init=False, scale_loss_weight=0.0,
               align_3d_loss_weight=0.0, track_worst_n=0)
    exp_root = str(tmp_path / "experiments")
    with pytest.raises(ValueError, match="pretrained_weight_on_synth"):
        S.train_sim2real(cfg, max_epochs=0, seg_teacher=small_teacher,
                         device="cpu", exp_root=exp_root)
    jcfg = jax_make_cfg(str(base / "s2r_handoff.yaml"))
    args = (np.zeros((1, 64, 64, 3), np.float32),
            np.zeros((1, 64, 64, 3), np.float32), np.ones((1,), np.float32),
            np.eye(3, dtype=np.float32)[None])
    variables = random_jax_variables(jax_build_fullnet(jcfg), args, seed=5)
    s2 = JE.create_train_state(variables, JE.make_optimizer(jcfg, 1))
    s2 = s2.replace(step=np.int32(777))
    ckpt = str(tmp_path / "synth_ckpt.pk")
    jax_save_checkpoint(ckpt, epoch=9, metric=0.5, state=s2)
    cfg.pretrained_weight_on_synth = ckpt
    state = S.train_sim2real(cfg, max_epochs=0, seg_teacher=small_teacher,
                             device="cpu", exp_root=exp_root)
    want = _sd(variables["params"], variables["batch_stats"])
    got = state.model.state_dict()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert not state.optimizer.state_dict()["state"]     # fresh Adam


def test_sim2real_resume_run(real_ws, tmp_path, small_teacher):
    """resume_run restores the whole state of the port's per-camera
    checkpoint and continues at its epoch + 1."""
    base, train_dir = real_ws
    cfg = _cfg(base, train_dir, "s2r_resume", epoch_size=2, track_worst_n=0)
    exp_root = str(tmp_path / "experiments")
    prev = S.train_sim2real(cfg, max_epochs=1, seg_teacher=small_teacher,
                            device="cpu", exp_root=exp_root)
    ckpt = os.path.join(exp_root, "s2r_resume", "ckpt",
                        "curr_best_auc(add)_azure_model.pk")
    save_checkpoint_file(ckpt, epoch=0, metric=0.1, state=prev)
    cfg2 = _cfg(base, train_dir, "s2r_resume2", epoch_size=2,
                track_worst_n=0, allow_random_init=False, resume_run=True,
                resume_experiment_name="s2r_resume")
    state2 = S.train_sim2real(cfg2, max_epochs=2, seg_teacher=small_teacher,
                              device="cpu", exp_root=exp_root)
    # one step restored, one more epoch of one step
    assert int(state2.optimizer.state_dict()["state"][0]["step"]) == 2


def test_missing_teacher_hard_fails(real_ws, tmp_path, monkeypatch):
    """A missing seg teacher aborts, not silently trains on garbage."""
    base, train_dir = real_ws
    monkeypatch.chdir(tmp_path)
    cfg = _cfg(base, train_dir, "s2r_teacher")
    with pytest.raises(FileNotFoundError, match="allow_random_teacher"):
        S.load_seg_teacher(cfg, device="cpu")
    cfg.allow_random_teacher = True
    assert S.load_seg_teacher(cfg, device="cpu").out_hw == (240, 320)


def test_unresolvable_teacher_camera_hard_fails(tmp_path):
    cfg = _cfg(tmp_path, tmp_path / "mystery_real_set", "s2r_camera")
    with pytest.raises(ValueError, match="azure, kinect, realsense, orb"):
        S.load_seg_teacher(cfg, device="cpu")
    cfg.allow_random_teacher = True
    assert S.load_seg_teacher(cfg, device="cpu") is not None


def test_load_seg_teacher_reads_the_jax_msgpack(real_ws, tmp_path,
                                                monkeypatch, teachers):
    """models/panda_segmentation/<camera>.msgpack, as the JAX package
    reads it, is read without flax."""
    from flax import serialization
    base, train_dir = real_ws
    _, _, variables = teachers
    monkeypatch.chdir(tmp_path)
    os.makedirs("models/panda_segmentation")
    with open("models/panda_segmentation/azure.msgpack", "wb") as f:
        f.write(serialization.msgpack_serialize(
            jax.tree.map(np.asarray, variables)))
    teacher = S.load_seg_teacher(_cfg(base, train_dir, "s2r_read"),
                                 device="cpu")
    want = seg_teacher_state_dict_from_jax(variables["params"],
                                           variables["batch_stats"])
    got = teacher.model.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_train_cli_runs_stage_3(real_ws, tmp_path, monkeypatch):
    """python -m horopose_tpu_torch.scripts.train --config <sim2real yaml>
    --device cpu: one epoch of a tiny stage 3 with a random full-size
    teacher (240x320 masks; a budget of 32 faces a tile keeps the CPU
    render short)."""
    base, train_dir = real_ws
    monkeypatch.chdir(tmp_path)
    path = tmp_path / "cli.yaml"
    path.write_text(yaml.safe_dump(dict(
        exp_name="s2r_cli", urdf_robot_name="panda", batch_size=2,
        epoch_size=2, n_epochs=1, n_dataloader_workers=0, image_size=64.0,
        lr=1e-8, use_schedule=False, use_sim2real=True,
        backbone_name="resnet18", rootnet_backbone_name="resnet18",
        iou_loss_weight=1.0, align_3d_loss_weight=1.0,
        reference_keypoint_id=3, allow_random_init=True,
        allow_random_teacher=True, raster_faces_per_tile=32,
        train_ds_names=str(train_dir))))
    train_cli.main(["--config", str(path), "--device", "cpu"])
    tags = [r["tag"] for r in _scalars("experiments", "s2r_cli")]
    assert "Train/loss_iou" in tags and "Val/AUC_ADD_azure" in tags
