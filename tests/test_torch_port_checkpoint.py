"""The port reading the JAX package's checkpoints, on the CPU: flax msgpack
decoding without flax (every ext type, chunked leaves), `Predictor.
from_experiment` on an experiment the JAX package wrote, a JAX DepthNet
checkpoint as stage 2's `pretrained_rootnet`, the JAX payload in
`restore_state`, `checkpoint_epoch` and the keeper, and the ImageNet
backbone loader `apply_pretrained_backbone`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import serialization

from horopose_tpu.config import make_cfg as jax_make_cfg
from horopose_tpu.config import make_default_cfg as jax_default_cfg
from horopose_tpu.core import engine as JE
from horopose_tpu.core.checkpoint import \
    save_checkpoint_file as jax_save_checkpoint
from horopose_tpu.models.depth_net import RootNet as JaxRootNet
from horopose_tpu.pipelines.common import \
    apply_pretrained_backbone as jax_apply_pretrained_backbone
from horopose_tpu.pipelines.common import build_fullnet as jax_build_fullnet
from horopose_tpu.pipelines.train_full import \
    init_fullnet_state as jax_init_fullnet_state
from horopose_tpu.predictor import Predictor as JaxPredictor
from horopose_tpu.tools.torch_weights import convert_resnet
from horopose_tpu_torch.core.checkpoint import (BestCheckpointKeeper,
                                                TrainState, checkpoint_epoch,
                                                is_jax_payload,
                                                load_checkpoint_file,
                                                model_state_dict,
                                                read_flax_msgpack,
                                                restore_state)
from horopose_tpu_torch.models.resnet import get_resnet
from horopose_tpu_torch.pipelines.common import (FullNetConfig,
                                                 apply_pretrained_backbone,
                                                 build_fullnet)
from horopose_tpu_torch.pipelines.train_depthnet import train_depthnet
from horopose_tpu_torch.pipelines.train_full import init_fullnet_state
from horopose_tpu_torch.predictor import Predictor
from horopose_tpu_torch.tools.jax_weights import fullnet_state_dict_from_jax

from test_torch_port_models import random_jax_variables, rel_err

REL_TOL = 1e-4
S = 64
OUTPUT_KEYS = ["joints", "rotation", "translation", "root_depth",
               "keypoints_3d", "keypoints_3d_integral", "keypoints_2d"]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fullnet_args(s=S):
    return (np.zeros((1, s, s, 3), np.float32),
            np.zeros((1, s, s, 3), np.float32), np.ones((1,), np.float32),
            np.eye(3, dtype=np.float32)[None])


def _same_tree(a, b, where=""):
    if isinstance(b, dict):
        assert isinstance(a, dict) and sorted(a) == sorted(b), where
        for k in b:
            _same_tree(a[k], b[k], f"{where}/{k}")
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def test_read_flax_msgpack_matches_flax():
    """Every leaf type flax writes: arrays of each dtype and rank, numpy
    scalars, Python complex, ints, floats, strings, nested dicts."""
    rng = np.random.RandomState(0)
    tree = dict(
        params=dict(conv=dict(kernel=rng.randn(3, 3, 2, 4).astype(np.float32),
                              bias=np.zeros(4, np.float32)),
                    table=rng.randint(-9, 9, (5, 2)).astype(np.int64)),
        scalars=dict(epoch=np.int64(7), metric=np.float64(0.25),
                     flag=np.bool_(True), half=np.float16(1.5)),
        raw=dict(i=3, f=2.5, s="text", c=complex(1.0, -2.0),
                 empty=np.zeros((0, 3), np.float32)),
        step=np.asarray(12, np.int32))
    data = serialization.msgpack_serialize(tree)
    _same_tree(read_flax_msgpack(data), serialization.msgpack_restore(data))


def test_read_flax_msgpack_widens_bfloat16():
    x = np.asarray(jnp.asarray([1.5, -2.25, 3e-3], jnp.bfloat16))
    out = read_flax_msgpack(serialization.msgpack_serialize({"w": x}))["w"]
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, x.astype(np.float32))


def test_read_flax_msgpack_rebuilds_chunked_leaves(monkeypatch):
    """flax splits an array over MAX_CHUNK_SIZE bytes into a dict of
    chunks; lowered here, a 3x5x7 f32 leaf splits into 9-element pieces."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 36)
    x = np.arange(105, dtype=np.float32).reshape(3, 5, 7)
    tree = dict(params=dict(big=x, small=np.ones(2, np.float32)))
    data = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    out = read_flax_msgpack(data)
    np.testing.assert_array_equal(out["params"]["big"], x)
    _same_tree(out, serialization.msgpack_restore(data))


@pytest.fixture(scope="module")
def jax_experiment(tmp_path_factory):
    """An experiment directory the JAX package wrote: config.yaml and a
    best-AUC checkpoint of a tiny FullNet (resnet18 and resnet18, 64 px,
    depth_dim 8) on numpy-random weights."""
    exp = tmp_path_factory.mktemp("jax_exp")
    (exp / "ckpt").mkdir()
    (exp / "config.yaml").write_text(yaml.safe_dump(dict(
        exp_name="jax_exp", urdf_robot_name="panda", image_size=float(S),
        backbone_name="resnet18", rootnet_backbone_name="resnet18",
        reference_keypoint_id=3)))
    jcfg = jax_make_cfg(str(exp / "config.yaml"))
    model = jax_build_fullnet(jcfg).clone(depth_dim=8)
    variables = random_jax_variables(model, _fullnet_args(), seed=11)
    state = JE.create_train_state(jax.tree.map(jnp.asarray, variables),
                                  JE.make_optimizer(jcfg, 1))
    jax_save_checkpoint(str(exp / "ckpt" / "curr_best_auc(add)_model.pk"),
                        epoch=5, metric=0.4, state=state)
    return exp, variables


def test_from_experiment_matches_jax(jax_experiment, monkeypatch):
    exp, _ = jax_experiment
    # depth_dim is not a config key: both packages build at 8 here
    import dataclasses
    import horopose_tpu.predictor as JPM
    build, from_cfg = JPM.build_fullnet, FullNetConfig.from_cfg
    monkeypatch.setattr(JPM, "build_fullnet",
                        lambda cfg: build(cfg).clone(depth_dim=8))
    monkeypatch.setattr(FullNetConfig, "from_cfg", classmethod(
        lambda cls, cfg: dataclasses.replace(from_cfg(cfg), depth_dim=8)))
    jpred = JaxPredictor.from_experiment(str(exp))
    pred = Predictor.from_experiment(str(exp), device="cpu")
    assert pred.model.depth_dim == 8
    rng = np.random.RandomState(808)
    images = rng.randint(0, 256, (2, S, S, 3), dtype=np.uint8)
    K = np.tile(np.asarray([[60.0, 0, 31.5], [0, 62.0, 32.5], [0, 0, 1]],
                           np.float32)[None], (2, 1, 1))
    ref, out = jpred(images, K), pred(images, K)
    for key in OUTPUT_KEYS:
        assert rel_err(out[key], ref[key]) <= REL_TOL, key


def test_model_state_dict_takes_either_payload(jax_experiment, tmp_path):
    exp, variables = jax_experiment
    payload = load_checkpoint_file(str(exp / "ckpt" /
                                       "curr_best_auc(add)_model.pk"))
    assert is_jax_payload(payload) and int(payload["epoch"]) == 5
    cfg = FullNetConfig(backbone_name="resnet18",
                        rootnet_backbone_name="resnet18", image_size=S,
                        depth_dim=8)
    model = build_fullnet(cfg)
    sd = model_state_dict(payload, model)
    want = fullnet_state_dict_from_jax(variables["params"],
                                       variables["batch_stats"], "resnet18",
                                       "resnet18")
    assert sorted(sd) == sorted(want)
    for k in want:
        assert torch.equal(sd[k], want[k]), k
    model.load_state_dict(sd)
    # weights-only restore of a JAX payload; with an optimizer, optax's
    # Adam state (a fresh run's: count 0, zero moments) restores too
    other = build_fullnet(cfg)
    restore_state(TrainState(other), payload)
    assert torch.equal(other.state_dict()["final_layer.weight"],
                       want["final_layer.weight"])
    opt = torch.optim.Adam(other.parameters())
    restore_state(TrainState(other, opt), payload)
    state = opt.state_dict()["state"]
    assert len(state) == len(list(other.parameters()))
    for s in state.values():
        assert int(s["step"]) == 0
        assert not s["exp_avg"].any() and not s["exp_avg_sq"].any()


def test_checkpoint_epoch_and_keeper_read_jax_files(jax_experiment, tmp_path):
    exp, _ = jax_experiment
    ckpt_dir = exp / "ckpt"
    assert checkpoint_epoch(str(ckpt_dir / "curr_best_auc(add)_model.pk")) \
        == 5
    keeper = BestCheckpointKeeper(str(ckpt_dir), "panda")
    assert keeper.resume()["dr"] == pytest.approx(0.4)
    # the epoch guard holds against the JAX file too
    model = build_fullnet(FullNetConfig(backbone_name="resnet18",
                                        rootnet_backbone_name="resnet18",
                                        image_size=S, depth_dim=8))
    assert keeper.maybe_save({"dr": 0.9}, TrainState(model), epoch=5) == []
    assert keeper.maybe_save({"dr": 0.9}, TrainState(model), epoch=6) == \
        ["dr"]


def test_jax_depthnet_checkpoint_hands_off_to_stage_2(tmp_path):
    """A stage-1 checkpoint the JAX package wrote, as the port's
    `pretrained_rootnet`: the same FullNet weights as the JAX hand-off."""
    s = 32
    jdepth = JaxRootNet(backbone_name="resnet34", input_size=s)
    dvars = random_jax_variables(jdepth, (np.zeros((1, s, s, 3), np.float32),
                                          np.ones((1,), np.float32)), seed=3)
    jckpt = str(tmp_path / "jax_depthnet.pk")
    jax_save_checkpoint(jckpt, epoch=3, metric=0.01,
                        state=JE.create_train_state(
                            jax.tree.map(jnp.asarray, dvars),
                            JE.make_optimizer(jax_default_cfg(), 1)))
    jcfg = jax_default_cfg()
    jcfg.update(image_size=float(s), backbone_name="resnet18",
                rootnet_backbone_name="resnet34", pretrained_rootnet=jckpt)
    jstate, _ = jax_init_fullnet_state(jcfg, jax_build_fullnet(jcfg),
                                       JE.make_optimizer(jcfg, 1))
    ref = fullnet_state_dict_from_jax(
        jax.tree.map(np.asarray, jstate.params),
        jax.tree.map(np.asarray, jstate.batch_stats), "resnet18", "resnet34")
    cfg = FullNetConfig(backbone_name="resnet18",
                        rootnet_backbone_name="resnet34", image_size=s,
                        pretrained_rootnet=jckpt)
    model = build_fullnet(cfg)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    after = init_fullnet_state(cfg, model).state_dict()
    handed = {k for k in after
              if k.startswith(("rootnet_backbone.", "depth_layer."))
              and not k.endswith("num_batches_tracked")}
    moved = {k for k in after if not torch.equal(after[k], before[k])}
    assert moved == handed
    for k in handed:
        np.testing.assert_array_equal(after[k].numpy(), ref[k].numpy(),
                                      err_msg=k)


def _resnet_file(tmp_path, arch="resnet18", seed=0, bad=True):
    """A raw torch state dict of a resnet trunk, as torchvision writes one
    (its `fc` head and BN counters included); bad: one tensor of the wrong
    shape."""
    torch.manual_seed(seed)
    sd = get_resnet(arch).state_dict()
    for k, v in sd.items():
        if v.is_floating_point():
            sd[k] = torch.randn_like(v)
    sd["fc.weight"] = torch.randn(1000, 512)
    sd["fc.bias"] = torch.randn(1000)
    if bad:
        sd["layer4.1.bn2.bias"] = torch.randn(7)
    path = str(tmp_path / f"{arch}.pth")
    torch.save({"state_dict": sd}, path)
    return path, sd


def test_apply_pretrained_backbone_counts_and_grafts(tmp_path):
    path, sd = _resnet_file(tmp_path)
    cfg = FullNetConfig(backbone_name="resnet18",
                        rootnet_backbone_name="resnet18", image_size=S)
    model = build_fullnet(cfg)
    root_before = model.rootnet_backbone.state_dict()
    n_params, n_stats, skipped = apply_pretrained_backbone(
        model, path, "resnet18", "reg_backbone")
    n_bn = sum(1 for k in sd if k.endswith("running_mean"))
    # 20 convs + 20 BNs (scale, bias) = 60 parameters, one with a wrong
    # shape; 20 BNs' mean and var
    assert (n_params, n_stats) == (59, 2 * n_bn)
    assert sorted(skipped) == ["fc.bias", "fc.weight", "layer4.1.bn2.bias"]
    got = model.reg_backbone.state_dict()
    for k, v in sd.items():
        if k in got and got[k].shape == v.shape \
                and not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], v), k
    for k, v in model.rootnet_backbone.state_dict().items():
        assert torch.equal(v, root_before[k]), k
    with pytest.raises(KeyError, match="no backbone"):
        apply_pretrained_backbone(model, path, "resnet18", "backbone")


def test_apply_pretrained_backbone_raises_on_zero_matches(tmp_path):
    path = str(tmp_path / "other.pth")
    torch.save({"head.weight": torch.zeros(3, 3)}, path)
    model = build_fullnet(FullNetConfig(backbone_name="resnet18",
                                        rootnet_backbone_name="resnet18",
                                        image_size=S))
    with pytest.raises(ValueError, match="ZERO"):
        apply_pretrained_backbone(model, path, "resnet18", "reg_backbone")


def test_apply_pretrained_backbone_matches_jax(tmp_path):
    """The .pth file and the converted msgpack (`tools/convert.py`'s
    layout) give the weights the JAX loader gives."""
    path, sd = _resnet_file(tmp_path, seed=1, bad=False)
    jcfg = jax_default_cfg()
    jcfg.update(image_size=float(S), backbone_name="resnet18",
                rootnet_backbone_name="resnet18")
    variables = random_jax_variables(jax_build_fullnet(jcfg), _fullnet_args(),
                                     seed=2)
    jstate = JE.create_train_state(jax.tree.map(jnp.asarray, variables),
                                   JE.make_optimizer(jcfg, 1))
    jstate = jax_apply_pretrained_backbone(jstate, path, "resnet18",
                                           "reg_backbone")
    ref = fullnet_state_dict_from_jax(
        jax.tree.map(np.asarray, jstate.params),
        jax.tree.map(np.asarray, jstate.batch_stats), "resnet18", "resnet18")
    tb = convert_resnet({k: v.numpy() for k, v in sd.items()}, (2, 2, 2, 2),
                        False)
    mp = str(tmp_path / "resnet18.msgpack")
    with open(mp, "wb") as f:
        f.write(serialization.msgpack_serialize(
            dict(params=tb.params, batch_stats=tb.batch_stats)))
    for artifact in (path, mp):
        model = build_fullnet(FullNetConfig(backbone_name="resnet18",
                                            rootnet_backbone_name="resnet18",
                                            image_size=S))
        model.load_state_dict(fullnet_state_dict_from_jax(
            variables["params"], variables["batch_stats"], "resnet18",
            "resnet18"), strict=False)
        apply_pretrained_backbone(model, artifact, "resnet18", "reg_backbone")
        got = model.state_dict()
        for k in ref:
            assert torch.equal(got[k], ref[k]), (artifact, k)


def test_train_depthnet_applies_backbone_pretrained(tmp_path):
    """stage 1's `backbone_pretrained`: the RootNet's backbone starts from
    the file."""
    from horopose_tpu_torch.config import make_default_cfg
    path, sd = _resnet_file(tmp_path, "resnet34")
    cfg = make_default_cfg()
    cfg.update(exp_name="pre", backbone_name="resnet34", image_size=32.0,
               use_rootnet=True, backbone_pretrained=path)
    state = train_depthnet(cfg, loaders={"train": [], "test": {}},
                           max_epochs=0, device="cpu",
                           exp_root=str(tmp_path / "experiments"))
    got = state.model.backbone.state_dict()
    assert torch.equal(got["conv1.weight"], sd["conv1.weight"])
    assert torch.equal(got["layer4.2.bn2.running_var"],
                       sd["layer4.2.bn2.running_var"])
