"""The stage-2 validation battery, the epoch loop, the test harness and the
CLI entry points of the port, on the CPU.

- `validate_full` against the JAX `validate_full`: the same loader batches
  and an eval step that returns the same seeded predictions; every scalar
  either one writes (about 40 tags) has the same tag, step and value at
  rtol 1e-5.
- A tiny stage-2 run from DREAM-layout files (resnet18 backbones, 64x64
  crops, b=2, one epoch of 2 steps, 2 loader workers): `train_full`, a
  checkpoint, `test_network` with its `summary.txt` holding the field
  names of `horopose_tpu/pipelines/test.py`'s summary in their order, and
  a resumed run (0 workers) that starts at the next epoch.
- `python -m horopose_tpu_torch.scripts.{train,test}`: the pipeline the
  config's flags pick, and the JAX script's flags.
"""

import ast
import inspect
import json
import os

import numpy as np
import pytest
import torch
import yaml

from fixtures import make_synthetic_dream_dataset
from horopose_tpu.config import make_cfg as jax_make_cfg
from horopose_tpu.data import DataLoader as JaxDataLoader
from horopose_tpu.data import DreamDataset as JaxDreamDataset
from horopose_tpu.kinematics import Robot as JaxRobot
from horopose_tpu.pipelines import test as jax_test
from horopose_tpu.pipelines.train_full import validate_full as jax_validate
from horopose_tpu_torch.config import make_cfg
from horopose_tpu_torch.core.checkpoint import save_checkpoint_file
from horopose_tpu_torch.core.engine import batch_to_torch
from horopose_tpu_torch.kinematics import Robot
from horopose_tpu_torch.pipelines import test as port_test
from horopose_tpu_torch.pipelines.train_full import (LOSS_TAGS, train_full,
                                                     validate_full)
from horopose_tpu_torch.scripts import test as test_cli
from horopose_tpu_torch.scripts import train as train_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOG_TAGS = ["loss", "rotation_diff"] + LOSS_TAGS


class Recorder:
    """A scalar writer that keeps (tag, value, step)."""

    def __init__(self):
        self.rows = []

    def add_scalar(self, tag, value, step):
        self.rows.append((tag, float(value), int(step)))

    def close(self):
        pass


@pytest.fixture(scope="module")
def dream(tmp_path_factory):
    base = tmp_path_factory.mktemp("eval")
    train = make_synthetic_dream_dataset(base / "dream", "panda", n_images=4,
                                         seed=0, split="train_dr")
    test = make_synthetic_dream_dataset(base / "dream", "panda", n_images=3,
                                        seed=1, split="test_dr")
    return str(train), str(test)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- the validation battery against JAX ----

def _fake_outputs(batch, seed):
    """Seeded predictions around the batch's ground truth, and losses."""
    rng = np.random.RandomState(seed)
    gt3 = np.asarray(batch["other"]["keypoints_3d"], np.float32)
    pose = np.asarray(batch["jointpose"], np.float32)
    preds = dict(xyz_fk=gt3 + rng.normal(0, 0.04, gt3.shape),
                 xyz_int=gt3 + rng.normal(0, 0.06, gt3.shape),
                 pose=pose + rng.normal(0, 0.1, pose.shape))
    gts = dict(gt_keypoints3d=gt3, gt_pose_before_mask=pose)
    logs = {t: float(rng.uniform(0, 2)) for t in LOG_TAGS}
    preds = {k: v.astype(np.float32) for k, v in preds.items()}
    return preds, gts, logs


def test_validate_full_battery_matches_jax(dream):
    """Same batches (3 + 1 frames, the last partial), same predictions:
    the same tags, steps and values."""
    _, test_dir = dream
    ds = JaxDreamDataset(test_dir, color_jitter=False, rgb_augmentation=False,
                         occlusion_augmentation=False,
                         rootnet_resize_hw=(32, 32), other_resize_hw=(32, 32))
    batches = list(JaxDataLoader(ds, batch_size=2, num_workers=1,
                                 drop_last=False))
    assert [int(b["TCO"].shape[0]) for b in batches] == [2, 1]
    outputs = [_fake_outputs(b, i) for i, b in enumerate(batches)]
    cfg = jax_make_cfg(os.path.join(REPO, "configs", "panda", "full.yaml"))

    jax_out = iter(outputs)
    ref = Recorder()
    auc_ref = jax_validate(cfg, JaxRobot("panda"),
                           lambda state, batch: next(jax_out), None,
                           batches, ref, 3, "dr")

    def port_step(batch):
        preds, gts, logs = next(port_out)
        return ({k: torch.from_numpy(v) for k, v in preds.items()},
                {k: torch.from_numpy(v) for k, v in gts.items()},
                {k: torch.tensor(v) for k, v in logs.items()})

    port_out = iter(outputs)
    ours = Recorder()
    auc = validate_full(make_cfg(os.path.join(REPO, "configs", "panda",
                                              "full.yaml")),
                        Robot("panda", device="cpu"), port_step,
                        [batch_to_torch(b, "cpu") for b in batches], ours, 3,
                        "dr")
    assert [r[0] for r in ours.rows] == [r[0] for r in ref.rows]
    assert len(ref.rows) == 15 + 8 + 8 + 2 * 7 + 8
    assert "Val/AUC_PCK_integral_xyz_metrics_dr" in [r[0] for r in ours.rows]
    for (tag, a, sa), (_, b, sb) in zip(ref.rows, ours.rows):
        assert sb == sa == 3
        assert b == pytest.approx(a, rel=1e-5, abs=1e-12), tag
    assert auc == pytest.approx(auc_ref, rel=1e-5)


# ---- the loop, the checkpoint and the harness ----

def _tiny_cfg_file(tmp_path, train_dir, exp_name, workers):
    values = dict(
        exp_name=exp_name, urdf_robot_name="panda",
        train_ds_names=train_dir, image_size=64.0,
        backbone_name="resnet18", rootnet_backbone_name="resnet18",
        batch_size=2, epoch_size=4, n_epochs=1,
        n_dataloader_workers=workers, lr=1e-4, clip_gradient=5.0,
        use_schedule=False, use_rootnet=True,
        use_rootnet_with_reg_int_shared_backbone=True,
        pose_loss_weight=1.0, rot_loss_weight=1.0, trans_loss_weight=1.0,
        uv_loss_weight=1.0, depth_loss_weight=10.0, kp2d_loss_weight=10.0,
        kp3d_loss_weight=10.0, kp2d_int_loss_weight=10.0,
        kp3d_int_loss_weight=10.0, reference_keypoint_id=3, fix_root=True)
    path = tmp_path / f"{exp_name}.yaml"
    path.write_text(yaml.safe_dump(values))
    return str(path)


def _jax_summary_fields(dof):
    """The field names of the JAX summary.txt, in order, read from the
    f-strings of `horopose_tpu.pipelines.test.test_network` (each field is
    the text before ": {value}"; loops expand over their thresholds)."""
    tree = ast.parse(inspect.getsource(jax_test.test_network))

    def name(node):
        if isinstance(node, ast.Constant):
            return node.value
        parts = []
        for v in node.values:
            if isinstance(v, ast.Constant):
                parts.append(v.value)
            else:
                parts.append("{}")
        text = "".join(parts)
        return text[:text.index(": {}")] if ": {}" in text else text

    fields = []
    for node in ast.walk(tree):
        target = (node.targets[0] if isinstance(node, ast.Assign) else
                  getattr(node, "target", None))
        if isinstance(target, ast.Name) and target.id == "lines":
            fields += [(node.lineno, name(e)) for e in node.value.elts]
        elif isinstance(node, ast.For) and "lines.append" in ast.unparse(
                node.body[0]):
            it = ast.unparse(node.iter)
            values = ([i + 1 for i in range(dof)] if "range" in it
                      else getattr(jax_test, it))
            template = name(node.body[0].value.args[0])
            fields += [(node.lineno, template.format(v)) for v in values]
    return [f for _, f in sorted(fields, key=lambda t: t[0])]


def test_jax_summary_fields_are_read_in_order():
    fields = _jax_summary_fields(8)
    assert fields[:3] == ["Model metrics summary", "Dataset for testing",
                          "This model was saved from epoch:{}"]
    assert fields[15] == "ADD<1mm" and fields[23] == "ADD_2d<2.5pixel"
    assert fields[31] == "Joint_l1_error/joint_1 (degree)"
    assert fields[-3:] == ["FPS_parallel", "FPS", ""]
    assert len(fields) == 15 + 8 + 8 + 8 + 9


def _summary_fields(text):
    """Field names of one summary.txt block (the text before ': ')."""
    out = []
    for line in text.split("\n"):
        if line.startswith("This model was saved from epoch:"):
            out.append("This model was saved from epoch:{}")
        else:
            out.append(line.split(": ")[0])
    return out


def test_train_checkpoint_test_and_resume(dream, tmp_path, one_thread):
    """One epoch of 2 steps with 2 loader workers, a best-AUC checkpoint,
    test_network on it (3 test frames at b=2: one padded batch), and a
    resumed run on 0 workers that starts at epoch 1."""
    train_dir, test_dir = dream
    root = str(tmp_path / "experiments")
    cfg = make_cfg(_tiny_cfg_file(tmp_path, train_dir, "tiny", 2))
    state = train_full(cfg, max_epochs=1, device="cpu", exp_root=root)
    assert state.scheduler.last_epoch == 2
    with open(os.path.join(root, "tiny", "log", "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    tags = {r["tag"] for r in rows}
    assert {"Train/loss_epoch", "Val/AUC_ADD_dr", "Val/PCK_20.0_pixel_dr",
            "Val/l1error_joint_8_dr"} <= tags
    assert all(np.isfinite(r["value"]) for r in rows)

    # a random model's ADD AUC is 0, which the keeper (strict "better than
    # 0") does not save: write the checkpoint as if epoch 0 had been best
    ckpt = os.path.join(root, "tiny", "ckpt", "curr_best_auc(add)_model.pk")
    assert not os.path.exists(ckpt)
    save_checkpoint_file(ckpt, epoch=0, metric=0.5, state=state)

    exp_path = os.path.join(root, "tiny")
    tcfg = port_test.make_test_cfg(exp_path, test_dir)
    summary = port_test.test_network(tcfg, batch_size=2, device="cpu")
    assert 0.0 <= summary["ADD/AUC"] <= 1.0
    with open(os.path.join(exp_path, "result", "summary.txt")) as f:
        text = f.read()
    assert _summary_fields(text.rstrip("\n")) + [""] == \
        _jax_summary_fields(8)
    assert "This model was saved from epoch:0\n" in text
    with open(os.path.join(exp_path, "result",
                           "add_distribution.json")) as f:
        dist = json.load(f)
    assert len(dist["dis3d"]) == 3 and dist["auc"] == summary["ADD/AUC"]

    resumed = make_cfg(_tiny_cfg_file(tmp_path, train_dir, "resumed", 0))
    resumed.resume_run = True
    resumed.resume_experiment_name = "tiny"
    state2 = train_full(resumed, max_epochs=2, device="cpu", exp_root=root)
    assert state2.scheduler.last_epoch == 4        # 2 restored + 2 new
    with open(os.path.join(root, "resumed", "log", "scalars.jsonl")) as f:
        epochs = {json.loads(line)["step"] for line in f
                  if json.loads(line)["tag"] == "Train/loss_epoch"}
    assert epochs == {1}


def test_measure_forward_fps_times_the_three_forwards(one_thread):
    """Per-image seconds for the full forward and each branch; the branch
    methods are the forward's own pieces."""
    from horopose_tpu_torch.pipelines.common import FullNetConfig
    from horopose_tpu_torch.pipelines.train_full import seeded_fullnet
    cfg = FullNetConfig(backbone_name="resnet18",
                        rootnet_backbone_name="resnet18", image_size=64,
                        depth_dim=8)
    model = seeded_fullnet(cfg).eval()
    x = torch.rand(2, 3, 64, 64)
    k = torch.full((2,), 1500.0)
    K = torch.tensor([[320.0, 0, 32], [0, 320.0, 32], [0, 0, 1]]).expand(
        2, 3, 3)
    with torch.no_grad():
        out = model(x, x, k, K)
        assert torch.equal(model.root_depth(x, k), out["depth"])
        uvd = model.keypoint_uvd(x)
        keep = torch.ones_like(uvd, dtype=torch.bool)
        keep[:, cfg.reference_keypoint_id, 2] = False      # the fixed root
        assert torch.equal(uvd[keep], out["uvd"][keep])
    times = port_test.measure_forward_fps(
        model, Robot("panda", device="cpu"), cfg, 2, "cpu", iters=2)
    assert sorted(times) == ["all", "other", "root"]
    assert all(t > 0 for t in times.values())


# ---- the CLI entry points ----

@pytest.mark.parametrize("config,pipeline", [
    ("configs/panda/full.yaml", "train_full"),
    ("configs/kuka/depthnet.yaml", "train_depthnet"),
    ("configs/panda/self_supervised/synth.yaml", "train_sim2real"),
])
def test_train_cli_picks_the_pipeline(config, pipeline, monkeypatch):
    import horopose_tpu_torch.pipelines.train_depthnet as TD
    import horopose_tpu_torch.pipelines.train_full as TF
    import horopose_tpu_torch.pipelines.train_sim2real as TS
    calls = []
    for module, name in ((TF, "train_full"), (TD, "train_depthnet"),
                         (TS, "train_sim2real")):
        monkeypatch.setattr(module, name,
                            lambda cfg, _n=name, **kw: calls.append(
                                (_n, cfg.exp_name, kw)))
    argv = ["--config", os.path.join(REPO, config), "--device", "cpu"]
    train_cli.main(argv)
    assert [c[0] for c in calls] == [pipeline]
    assert calls[0][2] == dict(device="cpu", dtype=torch.float32)


def test_test_cli_takes_the_jax_flags(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(test_cli, "make_test_cfg",
                        lambda exp, ds: dict(exp=exp, ds=ds))
    monkeypatch.setattr(test_cli, "test_network",
                        lambda cfg, **kw: calls.append((cfg, kw)))
    test_cli.main(["--exp_path", "e", "--dataset", str(tmp_path), "--ckpt",
                   "c.pk", "--batch_size", "4", "--device", "cpu"])
    assert calls == [(dict(exp="e", ds=str(tmp_path)),
                      dict(ckpt_name="c.pk", batch_size=4,
                           visualization=False, device="cpu"))]
