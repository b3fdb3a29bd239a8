"""The test harness's host side in the port against the JAX package: the
plots (`core/vis.py`), the shaded z-buffer render and the textured meshes
it draws (`core/shaded_render.py`, `kinematics/meshes.py`), the rendered
synthetic frames (`tools/synth_dream.py`), `core/profiling.py`,
`test_network` with its plots and a trace, and the loader's shutdown.

The render and the mesh reader are numpy in both packages, so they agree
to a level; only the FK that poses the robot differs by float32 rounding,
which moves a few edge pixels. No robot OBJ or texture file is in the
repository: the textured tests write a tiny OBJ, MTL and PNG into
`tmp_path`, as `tests/test_shaded_render.py` does. The loader tests fork
two worker processes.
"""

import gc
import json
import os
import time
import weakref

import numpy as np
import pytest
import torch
from PIL import Image

from horopose_tpu.core import shaded_render as JS
from horopose_tpu.core import vis as JV
from horopose_tpu.kinematics import Robot as JaxRobot
from horopose_tpu.kinematics import meshes as JM
from horopose_tpu.kinematics.urdf import parse_urdf as jax_parse_urdf
from horopose_tpu.tools.synth_dream import \
    make_synthetic_dream_dataset as jax_synth
from horopose_tpu_torch.core import profiling as TP
from horopose_tpu_torch.core import shaded_render as TS
from horopose_tpu_torch.core import vis as TV
from horopose_tpu_torch.data.samplers import DataLoader
from horopose_tpu_torch.kinematics import meshes as TM
from horopose_tpu_torch.kinematics.robot import Robot
from horopose_tpu_torch.kinematics.urdf import parse_urdf
from horopose_tpu_torch.tools.synth_dream import make_synthetic_dream_dataset

K_SMALL = np.array([[100.0, 0, 32], [0, 100.0, 32], [0, 0, 1]])


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_textured_obj(d):
    """A unit quad facing +z, left half red and right half blue in its
    texture, with a Kd-only second material on a triangle behind it."""
    tex = np.zeros((8, 8, 3), np.uint8)
    tex[:, :4] = [255, 0, 0]
    tex[:, 4:] = [0, 0, 255]
    Image.fromarray(tex).save(d / "tex.png")
    (d / "quad.mtl").write_text(
        "newmtl painted\nKd 1.0 1.0 1.0\nmap_Kd tex.png\n"
        "newmtl green\nKd 0.1 0.8 0.2\n")
    (d / "quad.obj").write_text(
        "mtllib quad.mtl\n"
        "v -0.5 -0.5 0\nv 0.5 -0.5 0\nv 0.5 0.5 0\nv -0.5 0.5 0\n"
        "v -0.8 -0.8 0.3\nv 0.8 -0.8 0.3\nv 0.0 0.8 0.3\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "usemtl painted\n"
        "f 1/1 2/2 3/3\nf 1/1 3/3 4/4\n"
        "usemtl green\n"
        "f 5 6 7\n")
    return d / "quad.obj"


def _urdf(obj_path):
    """A two-link robot: the textured OBJ on the base, a coloured box on
    the child."""
    return f"""<robot name="r">
      <link name="base">
        <visual><geometry><mesh filename="{obj_path}"/></geometry></visual>
      </link>
      <link name="arm">
        <visual>
          <origin xyz="0 0 0.2" rpy="0.3 0 0"/>
          <geometry><box size="0.2 0.3 0.1"/></geometry>
          <material name="m"><color rgba="0.9 0.5 0.1 1.0"/></material>
        </visual>
      </link>
      <joint name="j" type="fixed"><parent link="base"/><child link="arm"/>
      </joint>
    </robot>"""


# ---- meshes with appearance ----

def test_load_obj_textured_matches_jax(tmp_path):
    path = str(_write_textured_obj(tmp_path))
    ref = JM.load_obj_textured(path)
    out = TM.load_obj_textured(path)
    for a, b in zip(out[:4], ref[:4]):
        np.testing.assert_array_equal(a, b)
    assert [m["map_kd"] for m in out[4]] == [m["map_kd"] for m in ref[4]]
    for m, r in zip(out[4], ref[4]):
        np.testing.assert_array_equal(m["kd"], r["kd"])
    np.testing.assert_array_equal(TM.load_obj(path)[1], ref[1])


@pytest.mark.parametrize("with_appearance", [False, True])
def test_robot_mesh_matches_jax(with_appearance, tmp_path):
    urdf = _urdf(_write_textured_obj(tmp_path))
    index = {"base": 0, "arm": 1}
    ref = JM.build_robot_mesh(jax_parse_urdf(urdf), index,
                              with_appearance=with_appearance)
    out = TM.build_robot_mesh(parse_urdf(urdf), index,
                              with_appearance=with_appearance)
    for name in ("verts", "faces", "vert_link", "face_uv", "face_kd",
                 "face_tex"):
        a, b = getattr(out, name), getattr(ref, name)
        if b is None:
            assert a is None, name
        else:
            np.testing.assert_allclose(a, b, atol=1e-6, err_msg=name)
    assert len(out.textures) == len(ref.textures) == int(with_appearance)
    for a, b in zip(out.textures, ref.textures):
        np.testing.assert_array_equal(a, b)
    assert (out.n_file_geoms, out.n_primitive_geoms) == (1, 1)


# ---- the shaded render ----

@pytest.mark.parametrize("textured", [False, True])
def test_render_shaded_matches_jax(textured, tmp_path):
    v, f, face_uv, face_mat, mats = TM.load_obj_textured(
        str(_write_textured_obj(tmp_path)))
    verts = v + np.array([0, 0, 1.5], np.float32)
    kw = dict(face_colors=np.tile([[0.2, 0.6, 0.9]], (len(f), 1)))
    if textured:
        kw = dict(face_uv=face_uv, face_tex=face_mat.copy(),
                  textures=(TM._load_texture(mats[0]["map_kd"]),))
    ref_rgb, ref_depth = JS.render_shaded(verts, f, K_SMALL, (64, 64), **kw)
    rgb, depth = TS.render_shaded(verts, f, K_SMALL, (64, 64), **kw)
    assert rgb.any()
    assert np.abs(rgb.astype(int) - ref_rgb.astype(int)).max() <= 1
    np.testing.assert_array_equal(depth, ref_depth)
    if textured:      # red left of the principal point, blue right of it
        assert rgb[32, 20, 0] > 150 and rgb[32, 44, 2] > 150


@pytest.mark.parametrize("root", [0, 3])
def test_robot_shaded_render_matches_jax(root):
    """The panda's URDF primitives, posed by each package's FK: the same
    picture but for a few edge pixels."""
    jrobot, robot = JaxRobot("panda"), Robot("panda", device="cpu")
    index = {n: i for i, n in enumerate(robot.plan.link_names)}
    jmesh = JM.build_robot_mesh(jrobot.model, index, with_appearance=True)
    mesh = TM.build_robot_mesh(robot.model, index, with_appearance=True)
    cfg = np.linspace(-0.4, 0.4, 8).astype(np.float32)
    rot = np.array([1, 0, 0, 0, 0, -1], np.float32)
    trans = np.array([0.0, 0.1, 1.4], np.float32)
    K = np.array([[120.0, 0, 48], [0, 120.0, 36], [0, 0, 1]])
    bg = np.full((72, 96, 3), 30, np.uint8)
    ref, ref_blend = JS.render_robot_shaded(jrobot, jmesh, cfg, rot, trans,
                                            K, (72, 96), root=root,
                                            original_image=bg)
    out, blend = TS.render_robot_shaded(robot, mesh, cfg, rot, trans, K,
                                        (72, 96), root=root,
                                        original_image=bg)
    assert out.any(-1).mean() > 0.02
    differ = (np.abs(out.astype(int) - ref.astype(int)) > 1).any(-1)
    assert differ.mean() <= 0.01, differ.mean()
    differ = (np.abs(blend.astype(int) - ref_blend.astype(int)) > 1).any(-1)
    assert differ.mean() <= 0.01
    np.testing.assert_array_equal(TV.render_mesh(
        bg, robot, mesh, cfg, rot, trans, K, root=root), blend)


def test_synthetic_rendered_frames_match_jax(tmp_path):
    """render_images=True: the same annotations (the bbox widened to the
    rendered silhouette) and the same pictures up to JPEG levels."""
    kw = dict(robot_type="panda", n_images=2, seed=5, image_hw=(96, 128),
              render_images=True, view_mode="upright")
    ref_dir = jax_synth(tmp_path / "jax", **kw)
    out_dir = make_synthetic_dream_dataset(tmp_path / "port", **kw)
    names = sorted(os.listdir(out_dir))
    assert names == sorted(os.listdir(ref_dir))
    for name in names:
        if name.endswith(".json") and not name.startswith("_"):
            a = json.loads((out_dir / name).read_text())["objects"][0]
            b = json.loads((ref_dir / name).read_text())["objects"][0]
            for corner in ("min", "max"):
                np.testing.assert_allclose(a["bounding_box"][corner],
                                           b["bounding_box"][corner],
                                           atol=1.0)
        elif name.endswith(".jpg"):
            a = np.asarray(Image.open(out_dir / name), np.int32)
            b = np.asarray(Image.open(ref_dir / name), np.int32)
            assert (np.abs(a - b) > 24).any(-1).mean() <= 0.01
            assert a.std() > 5           # a picture, not a flat frame


# ---- the plots ----

def _kp(rng, n):
    kp3 = rng.randn(n, 7, 3) * 0.1 + [0, 0, 1.2]
    kp2 = rng.uniform(0, 64, (n, 7, 2))
    return kp3, kp2


def _vis_joints_3d(V, d, rng):
    images = rng.randint(0, 255, (2, 64, 64, 3)).astype(np.uint8)
    kp3_pred, kp2_pred = _kp(rng, 2)
    kp3_gt, kp2_gt = _kp(rng, 2)
    V.vis_joints_3d(images, kp3_pred, kp3_gt, kp2_pred, kp2_gt,
                    os.path.join(d, "vis_best_cases.jpg"), n_samples=2,
                    errors=[0.01, 0.02])


def _vis_3dkp_single_view(V, d, rng):
    V.vis_3dkp_single_view(_kp(rng, 1)[0][0], _kp(rng, 1)[0][0],
                           os.path.join(d, "view.png"))


def _draw_add_curve(V, d, rng):
    V.draw_add_curve({"dis3d": list(rng.uniform(0, 0.08, 50))}, d,
                     "/sets/panda_test", auc=0.42)


PLOTS = {"vis_joints_3d": _vis_joints_3d,
         "vis_3dkp_single_view": _vis_3dkp_single_view,
         "draw_add_curve": _draw_add_curve}


@pytest.mark.parametrize("plot", sorted(PLOTS))
def test_plots_write_the_jax_files(plot, tmp_path):
    for V, sub in ((JV, "jax"), (TV, "port")):
        os.makedirs(tmp_path / sub)
        PLOTS[plot](V, str(tmp_path / sub), np.random.RandomState(3))
    names = sorted(os.listdir(tmp_path / "port"))
    assert names and names == sorted(os.listdir(tmp_path / "jax"))
    for name in names:
        a = np.asarray(Image.open(tmp_path / "port" / name), np.int32)
        b = np.asarray(Image.open(tmp_path / "jax" / name), np.int32)
        assert a.shape == b.shape
        assert np.abs(a - b).mean() < 1.0


def test_plots_are_no_ops_without_matplotlib(tmp_path, monkeypatch):
    monkeypatch.setattr(TV, "_plt", lambda: None)
    for plot in PLOTS.values():
        plot(TV, str(tmp_path), np.random.RandomState(0))
    assert not os.listdir(tmp_path)


def test_test_network_writes_plots_and_a_trace(tmp_path):
    """The test harness on a random resnet18 model: the ADD curve, the
    best and worst cases with --visualization, and a torch.profiler trace
    under profile_dir."""
    import yaml
    from horopose_tpu_torch.config import make_cfg
    from horopose_tpu_torch.pipelines import test as port_test
    test_dir = make_synthetic_dream_dataset(tmp_path / "dream", "panda",
                                            n_images=5, seed=1,
                                            split="test_dr")
    exp = tmp_path / "exp"
    exp.mkdir()
    (exp / "config.yaml").write_text(yaml.safe_dump(dict(
        exp_name="exp", urdf_robot_name="panda", image_size=64.0,
        backbone_name="resnet18", rootnet_backbone_name="resnet18")))
    cfg = port_test.make_test_cfg(str(exp), str(test_dir))
    cfg.profile_dir = str(tmp_path / "profile")
    assert make_cfg(str(exp / "config.yaml")).image_size == 64.0
    port_test.test_network(cfg, batch_size=4, visualization=True,
                           device="cpu")
    written = set(os.listdir(exp / "result"))
    assert {"summary.txt", "add_distribution.json", "vis_best_cases.jpg",
            "vis_worst_cases.jpg",
            f"add_distribution_curve_{test_dir.name}.jpg"} <= written
    assert os.path.getsize(tmp_path / "profile" / "trace.json") > 0


# ---- profiling ----

def test_assert_finite_counts_without_a_host_read():
    tree = {"a": torch.tensor([1.0, float("nan"), 2.0]),
            "b": [torch.tensor([[float("inf"), 0.0]]), torch.arange(3)],
            "c": (torch.ones(2, dtype=torch.bfloat16),)}
    bad = TP.assert_finite(tree, "tree")
    assert isinstance(bad, torch.Tensor) and bad.dim() == 0
    assert int(bad) == 2
    assert int(TP.assert_finite({"x": torch.zeros(4)})) == 0
    assert int(TP.assert_finite({})) == 0


def test_step_timer_leaves_out_the_warm_up():
    timer = TP.StepTimer(skip_first=1)
    for dt in (0.2, 0.01, 0.01):
        with timer.measure():
            time.sleep(dt)
    assert 0.005 < timer.mean < 0.1


def test_chained_seconds_and_trace_on_cpu(tmp_path):
    w = torch.randn(32, 32) / 32

    def step(c, w):
        return torch.tanh(c @ w)

    s = TP.chained_seconds(step, torch.randn(8, 32), w, iters=5, passes=2)
    assert 0 < s < 1
    with TP.trace(str(tmp_path / "t")):
        step(torch.randn(8, 32), w)
    assert os.path.getsize(tmp_path / "t" / "trace.json") > 0


def test_enable_debug_nans_toggles_anomaly_detection():
    TP.enable_debug_nans(True)
    try:
        assert torch.is_anomaly_enabled()
    finally:
        TP.enable_debug_nans(False)
    assert not torch.is_anomaly_enabled()


# ---- the loader's shutdown ----

class _Items:
    def __len__(self):
        return 32

    def __getitem__(self, key):
        return {"x": np.full((4,), key[2], np.float32)}


def _gone(pid, timeout):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return True
        # a joined child is reaped; a zombie still answers kill(pid, 0)
        with open(f"/proc/{pid}/stat") as f:
            if f.read().split(")")[-1].split()[0] == "Z":
                return True
        time.sleep(0.02)
    return False


def _started_loader():
    loader = DataLoader(_Items(), batch_size=4, num_workers=2)
    batches = iter(loader)
    assert next(batches)["x"].shape == (4, 4)
    pids = [w.pid for w in loader._torch._iterator._workers]
    assert len(pids) == 2
    return loader, pids


def test_loader_close_stops_its_workers():
    loader, pids = _started_loader()
    t0 = time.perf_counter()
    loader.close()
    assert time.perf_counter() - t0 < 2.0
    assert all(_gone(pid, 2.0) for pid in pids)
    loader.close()                       # a second close is a no-op


def test_loader_is_freed_without_a_garbage_collection():
    """No reference cycle: `del` frees the loader, and its workers stop,
    with the collector off."""
    loader, pids = _started_loader()
    ref = weakref.ref(loader)
    gc.disable()
    try:
        t0 = time.perf_counter()
        del loader
        assert ref() is None
        assert time.perf_counter() - t0 < 2.0
        assert all(_gone(pid, 2.0) for pid in pids)
    finally:
        gc.enable()


def test_loader_epochs_count_the_passes():
    loader = DataLoader(_Items(), batch_size=8, num_workers=0,
                        drop_last=False)
    firsts = [next(iter(loader))["x"][0, 0].item() for _ in range(2)]
    assert loader.epoch == 2 and len(loader) == 4
    loader.epoch = 0
    assert next(iter(loader))["x"][0, 0].item() == firsts[0]
