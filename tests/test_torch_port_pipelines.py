"""Port config, checkpoints, loggers, stage-1 loop and the stage-1 -> 2
hand-off, on the CPU.

`make_cfg` against the JAX `make_cfg` on every file in `configs/` (the port
reads the YAML subset itself, without PyYAML); the YAML reader against
PyYAML on the subset's corner cases; `BestCheckpointKeeper` and the
checkpoint files; `ScalarWriter`; `train_depthnet` at a tiny size with its
resume; and `init_fullnet_state`'s hand-off against the JAX one, as
tests/test_stage_handoff.py runs it.
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
from horopose_tpu.config import make_default_cfg as jax_default_cfg
from horopose_tpu.core.checkpoint import \
    save_checkpoint_file as jax_save_checkpoint
from horopose_tpu.core.engine import create_train_state
from horopose_tpu.core.engine import make_optimizer as jax_make_optimizer
from horopose_tpu.models.depth_net import RootNet as JaxRootNet
from horopose_tpu.pipelines.common import build_fullnet as jax_build_fullnet
from horopose_tpu.pipelines.train_full import \
    init_fullnet_state as jax_init_fullnet_state
from horopose_tpu_torch.config import load_yaml, make_cfg, make_default_cfg
from horopose_tpu_torch.core.checkpoint import (BestCheckpointKeeper,
                                                TrainState, checkpoint_epoch,
                                                load_checkpoint_file,
                                                restore_state,
                                                save_checkpoint_file)
from horopose_tpu_torch.core.loggers import (DeviceLogAccumulator,
                                             ScalarWriter, create_logger)
from horopose_tpu_torch.data.synthetic import synthetic_dream_batch
from horopose_tpu_torch.kinematics import Robot
from horopose_tpu_torch.models import RootNet
from horopose_tpu_torch.pipelines.common import FullNetConfig, build_fullnet
from horopose_tpu_torch.pipelines.train_depthnet import (CKPT_TEMPLATE,
                                                         build_rootnet,
                                                         train_depthnet)
from horopose_tpu_torch.pipelines.train_full import init_fullnet_state
from horopose_tpu_torch.tools.jax_weights import (fullnet_state_dict_from_jax,
                                                  rootnet_state_dict_from_jax)

from test_torch_port_models import random_jax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, REPO) for p in glob.glob(
    os.path.join(REPO, "configs", "**", "*.yaml"), recursive=True))


def _same(a, b, where=""):
    """Equal values of equal types, lists element by element."""
    assert type(a) is type(b), (where, a, b)
    if isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


# ---- config ----

def test_default_cfg_matches_jax():
    ours, ref = make_default_cfg(), jax_default_cfg()
    assert sorted(ours) == sorted(ref)
    for k in ref:
        _same(ours[k], ref[k], k)


@pytest.mark.parametrize("path", CONFIGS)
def test_make_cfg_matches_jax(path):
    full = os.path.join(REPO, path)
    ours, ref = make_cfg(full), jax_make_cfg(full)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        _same(ours[k], ref[k], f"{path}: {k}")


YAML_CASES = {
    "exponent_without_dot": "lr : 1e-4\nb : 1.0e-4\n",
    "dot_floats": "a : 0.\nb : .5\nc : -2.50\nd : .inf\n",
    "none_is_a_string": "a : None\nb : ~\nc :\nd : null\n",
    "yaml11_booleans": "a : yes\nb : Off\nc : TRUE\nd : False\ne : y\n",
    "ints": "a : 0\nb : -3\nc : 1_000\nd : +7\n",
    "quotes_and_comments": "a : \"x # y\"  # z\nb : 'q'\nc : w#v\n# c\n",
    "lists": "a : [0.2, 0.13]\nb : []\nc :\n  - 1300\n  - 'x'\nd : 1\n",
}


@pytest.mark.parametrize("name", sorted(YAML_CASES))
def test_yaml_subset_reads_as_pyyaml(name):
    text = YAML_CASES[name]
    ref = yaml.safe_load(text)
    ours = load_yaml(text)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        _same(ours[k], ref[k], k)


@pytest.mark.parametrize("text", ["a :\n  b : 1\n", "  - 1\n", "a 1\n"])
def test_yaml_outside_the_subset_raises(text):
    with pytest.raises(ValueError):
        load_yaml(text)


@pytest.mark.parametrize("robot", ["panda", "kuka", "baxter"])
def test_fullnet_config_from_the_stage2_file(robot):
    """Every field FullNetConfig shares with the stage-2 config takes the
    JAX make_cfg's value, coerced to its type."""
    path = os.path.join(REPO, "configs", robot, "full.yaml")
    cfg, ref = FullNetConfig.from_cfg(make_cfg(path)), jax_make_cfg(path)
    assert cfg.urdf_robot_name == robot
    assert cfg.image_size == 256 and isinstance(cfg.image_size, int)
    assert cfg.bbox_3d_shape == (1300.0, 1300.0, 1300.0)
    for k, v in vars(cfg).items():
        if k in ref and k != "bbox_3d_shape":
            assert v == ref[k], k
    if robot == "panda":
        assert cfg == FullNetConfig()   # the defaults are the panda flagship
    bad = make_cfg(path)
    bad.backbone_pretrained = "imagenet.pth"
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        FullNetConfig.from_cfg(bad)


# ---- checkpoints and loggers ----

def _state(seed=0):
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 0.5 ** s)
    model(torch.randn(5, 3)).sum().backward()
    opt.step()
    sched.step()
    return TrainState(model, opt, sched)


def test_checkpoint_round_trip(tmp_path):
    path = str(tmp_path / "a.pk")
    state = _state(0)
    save_checkpoint_file(path, epoch=4, metric=0.25, state=state,
                         extra=dict(note=7))
    payload = load_checkpoint_file(path)
    assert (payload["epoch"], payload["metric"], payload["note"]) == (4, 0.25,
                                                                      7)
    assert checkpoint_epoch(path) == 4
    assert checkpoint_epoch(str(tmp_path / "none.pk")) == -1
    other = restore_state(_state(1), payload)
    for k, v in state.model.state_dict().items():
        assert torch.equal(other.model.state_dict()[k], v), k
    assert other.scheduler.last_epoch == state.scheduler.last_epoch == 1
    assert torch.equal(other.optimizer.state_dict()["state"][0]["exp_avg"],
                       state.optimizer.state_dict()["state"][0]["exp_avg"])


@pytest.mark.parametrize("mode", ["max", "min"])
def test_keeper_saves_improvements_only(mode, tmp_path):
    keeper = BestCheckpointKeeper(str(tmp_path), "kuka", template=CKPT_TEMPLATE,
                                  mode=mode)
    better, worse = (0.6, 0.4) if mode == "max" else (0.4, 0.6)
    state = _state()
    assert keeper.maybe_save({"dr": 0.5}, state, 0) == ["dr"]
    assert keeper.maybe_save({"dr": worse}, state, 1) == []
    assert keeper.maybe_save({"dr": better, "azure": better}, state, 2) == \
        ["dr"]                          # the real sets are panda's only
    path = keeper.paths["dr"]
    assert os.path.basename(path) == "curr_best_root_depth(wholistic)_model.pk"
    assert checkpoint_epoch(path) == 2
    assert load_checkpoint_file(path)["metric"] == better
    assert keeper.best["dr"] == better
    # a fresh keeper reads the bests back
    again = BestCheckpointKeeper(str(tmp_path), "kuka",
                                 template=CKPT_TEMPLATE, mode=mode)
    assert again.resume()["dr"] == better


def test_keeper_guards_against_epoch_regression(tmp_path):
    """A restarted run at an older epoch never overwrites a newer file,
    however good its metric; panda keeps the real sets too."""
    state = _state()
    first = BestCheckpointKeeper(str(tmp_path), "panda")
    assert first.maybe_save({"dr": 0.5, "azure": 0.3}, state, 5) == ["dr",
                                                                    "azure"]
    restarted = BestCheckpointKeeper(str(tmp_path), "panda")
    assert restarted.maybe_save({"dr": 0.9, "orb": 0.2}, state, 3) == ["orb"]
    assert checkpoint_epoch(restarted.paths["dr"]) == 5
    assert os.path.basename(restarted.paths["orb"]) == \
        "curr_best_auc(add)_orb_model.pk"
    with pytest.raises(ValueError, match="mode"):
        BestCheckpointKeeper(str(tmp_path), "panda", mode="mean")


def test_scalar_writer_and_logger(tmp_path):
    cfg = make_cfg(os.path.join(REPO, "configs", "panda", "depthnet.yaml"))
    save, ckpt, log, writer = create_logger(cfg, str(tmp_path))
    assert os.path.isdir(ckpt) and os.path.isdir(log)
    with open(os.path.join(save, "config.yaml")) as f:
        assert f.read() == open(cfg.config_path).read()
    writer.add_scalar("Val/mean_depth_error_dr", torch.tensor(0.25), 3)
    writer.add_scalar("Train/loss", np.float32(1.5), 100)
    writer.close()
    ScalarWriter(log).close()           # appends, never truncates
    with open(os.path.join(log, "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [(r["tag"], r["value"], r["step"]) for r in rows] == [
        ("Val/mean_depth_error_dr", 0.25, 3), ("Train/loss", 1.5, 100)]
    assert all(isinstance(r["t"], float) for r in rows)


def test_device_log_accumulator_flushes_in_windows():
    acc = DeviceLogAccumulator(flush_every=2)
    for v in (1.0, 2.0, 3.0):
        acc.push(dict(loss=torch.tensor(v), aux=torch.tensor(2 * v)))
    assert acc.meters["loss"].n == 2          # one window flushed
    acc.flush()
    acc.flush()                               # nothing pending: no change
    assert acc.mean("loss") == pytest.approx(2.0)
    assert acc.mean("aux") == pytest.approx(4.0)
    assert acc.mean("absent") == 0.0


# ---- stage 1 and the hand-off ----

def _tiny_cfg(**overrides):
    cfg = make_cfg(os.path.join(REPO, "configs", "panda", "depthnet.yaml"))
    cfg.update(backbone_name="resnet34", image_size=32.0, batch_size=2,
               **overrides)
    return cfg


def test_train_depthnet_needs_loaders(tmp_path):
    """Without loaders it takes the config's DREAM loaders
    (get_dataloaders), which name the train set when it holds no frame."""
    cfg = _tiny_cfg(train_ds_names=str(tmp_path / "panda_synth_train_dr"))
    with pytest.raises(FileNotFoundError, match="panda_synth_train_dr"):
        train_depthnet(cfg, device="cpu", exp_root=str(tmp_path))


def test_build_rootnet_is_seeded_and_leaves_the_global_generator():
    state = torch.random.get_rng_state()
    a, b = build_rootnet(_tiny_cfg()), build_rootnet(_tiny_cfg())
    assert torch.equal(torch.random.get_rng_state(), state)
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k


@pytest.fixture
def one_thread():
    """Tiny models on one intra-op thread: under pytest-xdist every worker
    would otherwise run torch's full thread pool on the shared cores, and
    the many small ops of this loop spin (2.7 s alone, 120 s so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_depthnet_runs_validates_saves_and_resumes(tmp_path,
                                                          one_thread):
    """The stage-1 loop at 32x32, b=2 on synthetic batches: the scalars,
    the min-mode checkpoint, and a resumed run that starts after the
    checkpoint's epoch from its weights."""
    robot = Robot("panda", device="cpu")
    train = [synthetic_dream_batch(robot, 2, 32, 32, seed=s, device="cpu")
             for s in range(2)]
    val = [synthetic_dream_batch(robot, 2, 32, 32, seed=9, device="cpu")]
    loaders = {"train": train, "test": {"dr": val}}
    root = str(tmp_path)
    cfg = _tiny_cfg()
    state = train_depthnet(cfg, loaders, max_epochs=2, device="cpu",
                           exp_root=root)
    log = os.path.join(root, cfg.exp_name, "log", "scalars.jsonl")
    with open(log) as f:
        rows = [json.loads(line) for line in f]
    tags = {(r["tag"], r["step"]) for r in rows}
    for epoch in (0, 1):
        for tag in ("Train/loss_epoch", "Val/rootz_loss_dr",
                    "Val/mean_depth_error_dr"):
            assert (tag, epoch) in tags
    ckpt = os.path.join(root, cfg.exp_name, "ckpt",
                        CKPT_TEMPLATE.replace("_DATASET", ""))
    payload = load_checkpoint_file(ckpt)
    errors = {r["step"]: r["value"] for r in rows
              if r["tag"] == "Val/mean_depth_error_dr"}
    assert payload["metric"] == pytest.approx(min(errors.values()))
    assert state.scheduler.last_epoch == 4        # 2 epochs of 2 steps

    resumed = _tiny_cfg(exp_name="resumed", resume_run=True,
                        resume_experiment_name=cfg.exp_name)
    import horopose_tpu_torch.pipelines.train_depthnet as TD
    original, first = TD.build_depthnet_train_step, {}

    def recording(cfg_, model, opt, sched):
        step = original(cfg_, model, opt, sched)

        def run(batch):
            if not first:
                first.update({k: v.clone()
                              for k, v in model.state_dict().items()})
            return step(batch)
        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TD, "build_depthnet_train_step", recording)
        train_depthnet(resumed, loaders, max_epochs=3, device="cpu",
                       exp_root=root)
    for k, v in payload["model"].items():     # started from the checkpoint
        assert torch.equal(first[k], v), k
    with open(os.path.join(root, "resumed", "log", "scalars.jsonl")) as f:
        steps = {json.loads(line)["step"] for line in f}
    assert steps == {2}                        # only the epoch after it


def test_handoff_matches_jax(tmp_path):
    """The same stage-1 weights handed to stage 2 by both packages: the
    JAX RootNet's `ResNet_0` subtree (the port's `backbone`) lands in
    FullNet's `rootnet_backbone`, BN statistics included, and `depth_layer`
    in `depth_layer`; nothing else of FullNet changes."""
    S = 32
    jdepth = JaxRootNet(backbone_name="resnet34", input_size=S)
    dvars = random_jax_variables(jdepth, (np.zeros((1, S, S, 3), np.float32),
                                          np.ones((1,), np.float32)), seed=3)
    jckpt = str(tmp_path / "jax_depthnet.pk")
    jax_save_checkpoint(jckpt, epoch=3, metric=0.01, state=create_train_state(
        jax.tree.map(jnp.asarray, dvars),
        jax_make_optimizer(jax_default_cfg(), 1)))
    jcfg = jax_default_cfg()
    jcfg.update(image_size=float(S), backbone_name="resnet18",
                rootnet_backbone_name="resnet34", pretrained_rootnet=jckpt)
    jstate, _ = jax_init_fullnet_state(jcfg, jax_build_fullnet(jcfg),
                                       jax_make_optimizer(jcfg, 1))
    ref = fullnet_state_dict_from_jax(
        jax.tree.map(np.asarray, jstate.params),
        jax.tree.map(np.asarray, jstate.batch_stats), "resnet18", "resnet34")

    rootnet = RootNet(backbone_name="resnet34")
    rootnet.load_state_dict(rootnet_state_dict_from_jax(
        dvars["params"], dvars["batch_stats"], "resnet34"))
    pckpt = str(tmp_path / "port_depthnet.pk")
    save_checkpoint_file(pckpt, epoch=3, metric=0.01,
                         state=TrainState(rootnet))
    cfg = FullNetConfig(backbone_name="resnet18",
                        rootnet_backbone_name="resnet34", image_size=S,
                        pretrained_rootnet=pckpt)
    model = build_fullnet(cfg)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    init_fullnet_state(cfg, model)
    after = model.state_dict()
    moved = {k for k in after if not torch.equal(after[k], before[k])}
    handed = {k for k in after
              if k.startswith(("rootnet_backbone.", "depth_layer."))
              and not k.endswith("num_batches_tracked")}
    assert moved == handed
    for k in handed:
        np.testing.assert_array_equal(after[k].numpy(), ref[k].numpy(),
                                      err_msg=k)
    np.testing.assert_array_equal(
        after["rootnet_backbone.bn1.running_mean"].numpy(),
        dvars["batch_stats"]["ResNet_0"]["bn1"]["mean"])


def test_handoff_rejects_another_backbone(tmp_path):
    path = str(tmp_path / "d.pk")
    save_checkpoint_file(path, epoch=0, metric=1.0,
                         state=TrainState(RootNet(backbone_name="resnet50")))
    cfg = FullNetConfig(backbone_name="resnet18",
                        rootnet_backbone_name="resnet34", image_size=32,
                        pretrained_rootnet=path)
    with pytest.raises(ValueError, match="does not"):
        init_fullnet_state(cfg, build_fullnet(cfg))
    unchanged = FullNetConfig(backbone_name="resnet18",
                              rootnet_backbone_name="resnet34", image_size=32)
    model = build_fullnet(unchanged)
    assert init_fullnet_state(unchanged, model) is model
