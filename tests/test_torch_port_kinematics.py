"""Port kinematics against the JAX package: FK plan, the FK lift
`Robot.get_keypoints_root` and `Robot.get_rotation_at_specific_root`, on
all three built-in URDFs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horopose_tpu import constants as JC
from horopose_tpu.kinematics import Robot as JaxRobot
from horopose_tpu_torch import constants as TC
from horopose_tpu_torch.kinematics import Robot

# f32 FK: keypoints in metres, chains of up to ~10 4x4 products
ATOL = 1e-5
ROBOTS = ["panda", "kuka", "baxter"]


def _cfg(rng, robot_type, n):
    lo, hi = JC.JOINT_BOUNDS[robot_type].T
    return rng.uniform(lo, hi, (n, len(lo))).astype(np.float32)


@pytest.fixture(scope="module", params=ROBOTS)
def robots(request):
    return (JaxRobot(request.param), Robot(request.param, device="cpu"))


@pytest.mark.parametrize("root", [0, 3])
def test_get_keypoints_root_matches_jax(robots, root, rng):
    jrobot, trobot = robots
    B = 5
    cfg = _cfg(rng, trobot.robot_type, B)
    rot = rng.randn(B, 6).astype(np.float32)
    trans = (rng.randn(B, 3) * 0.2 + [0, 0, 1.5]).astype(np.float32)
    ref = np.asarray(jrobot.get_keypoints_root(
        jnp.asarray(cfg), jnp.asarray(rot), jnp.asarray(trans), root=root))
    out = trobot.get_keypoints_root(torch.from_numpy(cfg),
                                    torch.from_numpy(rot),
                                    torch.from_numpy(trans), root=root)
    assert out.shape == (B, trobot.num_keypoints, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("root", [0, 3])
def test_get_rotation_at_specific_root_matches_jax(robots, root, rng):
    jrobot, trobot = robots
    B = 5
    cfg = _cfg(rng, trobot.robot_type, B)
    rot = rng.randn(B, 6).astype(np.float32)
    trans = (rng.randn(B, 3) * 0.2 + [0, 0, 1.5]).astype(np.float32)
    ref = np.asarray(jrobot.get_rotation_at_specific_root(
        jnp.asarray(cfg), jnp.asarray(rot), jnp.asarray(trans), root=root))
    out = trobot.get_rotation_at_specific_root(
        torch.from_numpy(cfg), torch.from_numpy(rot),
        torch.from_numpy(trans), root=root)
    assert out.shape == (B, 6)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


def test_link_poses_match_jax(robots, rng):
    jrobot, trobot = robots
    assert trobot.plan.link_names == jrobot.plan.link_names
    assert trobot.link_names == jrobot.link_names
    cfg = _cfg(rng, trobot.robot_type, 6).reshape(2, 3, -1)  # nested batch
    ref = np.asarray(jrobot.plan.link_poses(jnp.asarray(cfg)))
    out = trobot.plan.link_poses(torch.from_numpy(cfg)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_constants_are_copies():
    for name in ("DOF", "NUM_KEYPOINTS", "KEYPOINT_NAMES", "LINK_NAMES",
                 "JOINT_NAMES", "BAXTER_KEYPOINT_JOINTS",
                 "INITIAL_JOINT_ANGLE", "JOINT_TO_KP", "GLOBAL_SEED"):
        assert getattr(TC, name) == getattr(JC, name), name
    for robot in ROBOTS:
        np.testing.assert_array_equal(
            TC.initial_joint_vector("mean", robot),
            JC.initial_joint_vector("mean", robot))


def test_robot_rejects_unknown_type_and_bad_root():
    with pytest.raises(ValueError, match="unknown robot"):
        Robot("ur5", device="cpu")
    robot = Robot("panda", device="cpu")
    with pytest.raises(ValueError, match="root"):
        robot.get_keypoints_root(torch.zeros(1, 8), torch.zeros(1, 6),
                                 torch.zeros(1, 3), root=7)


def test_make_robot_reads_the_user_urdf(tmp_path, monkeypatch, rng):
    """A URDF under `<data dir>/deps/panda-description/` with a link mesh
    (an OBJ the test writes): both packages' `make_robot` build from it,
    with the same FK and the same mesh; without the file both fall back
    to the built-in description."""
    from chip_smoke import write_user_urdf
    from horopose_tpu import config as jax_config
    from horopose_tpu.kinematics.meshes import \
        build_robot_mesh as jax_build_robot_mesh
    from horopose_tpu.pipelines.common import make_robot as jax_make_robot
    from horopose_tpu_torch import config
    from horopose_tpu_torch.kinematics.meshes import build_robot_mesh
    from horopose_tpu_torch.kinematics.robot import BUILTIN_URDF
    from horopose_tpu_torch.pipelines.common import FullNetConfig, make_robot

    path = str(tmp_path / "deps" / "panda-description" / "panda.urdf")
    for module in (config, jax_config):
        monkeypatch.setitem(module.URDF_PATHS, "panda", path)
    jcfg = jax_config.make_default_cfg()
    cfg = FullNetConfig()
    builtin = (jax_make_robot(jcfg), make_robot(cfg, device="cpu"))
    assert builtin[1].urdf_path == BUILTIN_URDF["panda"]
    assert builtin[0].urdf_path.endswith("panda.urdf") and \
        builtin[0].urdf_path != path

    assert write_user_urdf(str(tmp_path)) == path
    jrobot, trobot = jax_make_robot(jcfg), make_robot(cfg, device="cpu")
    assert jrobot.urdf_path == trobot.urdf_path == path

    def mesh(robot, build):
        return build(robot.model, {n: i for i, n in
                                   enumerate(robot.plan.link_names)})

    jmesh, tmesh = mesh(jrobot, jax_build_robot_mesh), mesh(
        trobot, build_robot_mesh)
    assert tmesh.n_file_geoms == jmesh.n_file_geoms == 1
    assert not tmesh.missing_meshes and not jmesh.missing_meshes
    assert tmesh.verts.shape == jmesh.verts.shape
    assert tmesh.num_faces == jmesh.num_faces != mesh(
        builtin[1], build_robot_mesh).num_faces
    np.testing.assert_allclose(tmesh.verts, jmesh.verts, atol=1e-6)
    np.testing.assert_array_equal(tmesh.faces, jmesh.faces)
    np.testing.assert_array_equal(tmesh.vert_link, jmesh.vert_link)

    B = 6
    q = _cfg(rng, "panda", B)
    rot = rng.randn(B, 6).astype(np.float32)
    trans = (rng.randn(B, 3) * 0.2 + [0, 0, 1.5]).astype(np.float32)
    ref = np.asarray(jrobot.get_keypoints_root(
        jnp.asarray(q), jnp.asarray(rot), jnp.asarray(trans), root=3))
    out = trobot.get_keypoints_root(torch.from_numpy(q),
                                    torch.from_numpy(rot),
                                    torch.from_numpy(trans), root=3)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)
