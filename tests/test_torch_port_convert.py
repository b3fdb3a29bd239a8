"""The port's converter of the reference's torch weight files
(`tools/convert.py`, `tools/torch_weights.py`) against the JAX package's,
on the CPU.

For each of the JAX CLI's seven kinds a state dict under the reference's
names is seeded with numpy. The JAX route is the JAX converter
(`convert_*`, merged into the JAX model's variables as its CLI does, the
variables from `jax.eval_shape` with zero values) followed by the port's
`*_state_dict_from_jax`; the port route is `python -m
horopose_tpu_torch.tools.convert` (`main(argv)` in-process). The two must
give equal tensors key by key. No JAX model is initialised or run except
the one teacher forward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from horopose_tpu.models.deeplab import KeypointSegNet as JaxSegNet
from horopose_tpu.models.depth_net import RootNet as JaxRootNet
from horopose_tpu.models.hrnet import get_hrnet as jax_get_hrnet
from horopose_tpu.models.resnet import RESNET_SPECS
from horopose_tpu.models.resnet import get_resnet as jax_get_resnet
from horopose_tpu.tools.torch_weights import (
    convert_ctrnet_seg, convert_fullnet_reference_checkpoint, convert_hrnet,
    convert_resnet, convert_rootnet_reference_checkpoint, merge_into)
from horopose_tpu_torch.core.checkpoint import (TrainState,
                                                load_checkpoint_file,
                                                restore_state)
from horopose_tpu_torch.models.deeplab import KeypointSegNet
from horopose_tpu_torch.predictor import Predictor
from horopose_tpu_torch.tools import convert as CV
from horopose_tpu_torch.tools.jax_weights import (
    backbone_state_dict_from_jax, fullnet_state_dict_from_jax,
    rootnet_state_dict_from_jax, seg_teacher_state_dict_from_jax)
from horopose_tpu_torch.tools.torch_weights import (ctrnet_seg_state_dict,
                                                    load_torch_file)

from test_torch_port_models import rel_err

S = 64
SMALL = dict(backbone="resnet18", rootnet_backbone="resnet18", image_size=S)
# the port's and the JAX RootNet take resnet34/50 and hrnet32
DEPTHNET_BACKBONE = "resnet34"
REL_TOL = 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded(shapes, seed):
    """{name: tensor} of `shapes` ({name: (shape, dtype)}) from a numpy
    seed: He-normal weights, BN scales near 0.5, positive variances."""
    rng = np.random.RandomState(seed)
    out = {}
    for key, (shape, dtype) in shapes.items():
        if key.endswith("num_batches_tracked"):
            v = np.asarray(rng.randint(0, 100), np.int64)
        elif key.endswith("running_var"):
            v = 0.5 + rng.rand(*shape)
        elif key.endswith("running_mean"):
            v = 0.1 * rng.randn(*shape)
        elif len(shape) == 1:
            v = 0.5 + 0.05 * rng.randn(*shape) if key.endswith("weight") \
                else 0.01 * rng.randn(*shape)
        else:
            v = rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        out[key] = torch.from_numpy(np.asarray(v).astype(
            np.int64 if dtype == torch.int64 else np.float32))
    return out


def ctrnet_reference_shapes():
    """The CtRNet KeyPointSegNet's state dict names and shapes, as
    torchvision's DeepLabHead nested in KeyPointSegNet's Sequential lays
    them out (written here, not derived from the port's map)."""
    shapes = {}

    def conv(name, o, i, k, bias=False):
        shapes[f"{name}.weight"] = ((o, i, k, k), torch.float32)
        if bias:
            shapes[f"{name}.bias"] = ((o,), torch.float32)

    def bn(name, c):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{name}.{leaf}"] = ((c,), torch.float32)
        shapes[f"{name}.num_batches_tracked"] = ((), torch.int64)

    conv("backbone.0.conv1", 64, 3, 7)
    bn("backbone.0.bn1", 64)
    cin = 64
    for stage, n in enumerate((3, 4, 6, 3)):
        f = 64 * 2 ** stage
        for i in range(n):
            p = f"backbone.0.layer{stage + 1}.{i}"
            conv(f"{p}.conv1", f, cin, 1)
            bn(f"{p}.bn1", f)
            conv(f"{p}.conv2", f, f, 3)
            bn(f"{p}.bn2", f)
            conv(f"{p}.conv3", 4 * f, f, 1)
            bn(f"{p}.bn3", 4 * f)
            if i == 0:
                conv(f"{p}.downsample.0", 4 * f, cin, 1)
                bn(f"{p}.downsample.1", 4 * f)
            cin = 4 * f
    shapes["read_out.kps_score_lowres.weight"] = ((2048, 7, 4, 4),
                                                  torch.float32)
    shapes["read_out.kps_score_lowres.bias"] = ((7,), torch.float32)
    aspp = "classifer.0.0"
    for i, k in enumerate((1, 3, 3, 3)):
        conv(f"{aspp}.convs.{i}.0", 256, 2048, k)
        bn(f"{aspp}.convs.{i}.1", 256)
    conv(f"{aspp}.convs.4.1", 256, 2048, 1)
    bn(f"{aspp}.convs.4.2", 256)
    conv(f"{aspp}.project.0", 256, 1280, 1)
    bn(f"{aspp}.project.1", 256)
    conv("classifer.0.1", 256, 256, 3)
    bn("classifer.0.2", 256)
    conv("classifer.0.4", 1, 256, 1, bias=True)
    return shapes


def flat_ctrnet(sd):
    """The hand-flattened layout: `classifer.0.0` -> `classifer.0`,
    `classifer.0.{1,2,4}` -> `classifer.{1,2,4}`."""
    out = {}
    for k, v in sd.items():
        if k.startswith("classifer.0."):
            k = "classifer." + k[len("classifer.0."):]
        out[k] = v
    return out


def _model_args(kind):
    if kind == "depthnet":
        return dict(SMALL, backbone=DEPTHNET_BACKBONE)
    return SMALL


def reference_state_dict(kind, seed=0):
    """A seeded state dict under the reference's names. FullNet, RootNet
    and the backbones carry the reference's names in the port, so their
    names and shapes are read off the port's target model."""
    if kind == "ctrnet_seg":
        return seeded(ctrnet_reference_shapes(), seed)
    model = CV.build_target(kind, **_model_args(kind))
    return seeded({k: (tuple(v.shape), v.dtype)
                   for k, v in model.state_dict().items()}, seed)


def _zeros(shapes):
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def jax_route(kind, sd):
    """The JAX converter, merged into the JAX model's variables as its CLI
    does, then the port's map of flax variables -> the port's state dict."""
    sd = {k: v.numpy() for k, v in sd.items()}
    x = jnp.zeros((1, S, S, 3))
    if kind.startswith("resnet"):
        block, sizes = RESNET_SPECS[kind]
        model, args = jax_get_resnet(kind), (x,)
        tb = convert_resnet(sd, sizes, block == "bottleneck")
    elif kind == "hrnet32":
        model, args = jax_get_hrnet(32), (x,)
        tb = convert_hrnet(sd)
    elif kind == "ctrnet_seg":
        model, args = JaxSegNet(), (jnp.zeros((1, 64, 80, 3)),)
        tb = convert_ctrnet_seg(sd)
    elif kind == "depthnet":
        model = JaxRootNet(backbone_name=DEPTHNET_BACKBONE, input_size=S)
        args = (x, jnp.ones((1,)))
        tb = convert_rootnet_reference_checkpoint(sd, DEPTHNET_BACKBONE)
    else:
        from horopose_tpu.config import make_default_cfg
        from horopose_tpu.pipelines.common import build_fullnet
        cfg = make_default_cfg()
        cfg.update(backbone_name="resnet18", rootnet_backbone_name="resnet18",
                   image_size=float(S))
        model = build_fullnet(cfg)
        args = (x, x, jnp.ones((1,)), jnp.eye(3)[None])
        tb = convert_fullnet_reference_checkpoint(sd, "resnet18", "resnet18")
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
        *args, train=False))
    variables = merge_into(_zeros(shapes), tb)
    params, stats = variables["params"], variables.get("batch_stats", {})
    if kind == "fullnet":
        return fullnet_state_dict_from_jax(params, stats, "resnet18",
                                           "resnet18"), variables
    if kind == "depthnet":
        return rootnet_state_dict_from_jax(params, stats,
                                           DEPTHNET_BACKBONE), variables
    if kind == "ctrnet_seg":
        return seg_teacher_state_dict_from_jax(params, stats), variables
    out, left = backbone_state_dict_from_jax(params, stats, kind)
    assert not left, left
    return out, variables


def port_route(kind, sd, tmp_path):
    """`python -m horopose_tpu_torch.tools.convert kind src dst` (main in
    this process) -> the state dict the port's loaders read from dst."""
    src, dst = str(tmp_path / f"{kind}.pth"), str(tmp_path / f"{kind}.out")
    torch.save({"model_state_dict": sd, "epoch": 7}, src)
    args = _model_args(kind)
    argv = [kind, src, dst, "--backbone", args["backbone"],
            "--rootnet_backbone", args["rootnet_backbone"], "--image_size",
            str(S)]
    assert CV.main(argv) == 0
    if kind in ("fullnet", "depthnet"):
        payload = load_checkpoint_file(dst)
        assert payload["epoch"] == 7
        return payload["model"]
    return torch.load(dst, weights_only=True)


def assert_same(port, jax_sd):
    """Every key of the JAX route equal in the port's; the port's other
    keys are BatchNorm counters, which flax has no leaf for."""
    assert set(jax_sd) <= set(port)
    extra = set(port) - set(jax_sd)
    assert all(k.endswith("num_batches_tracked") for k in extra), extra
    for k, v in jax_sd.items():
        assert port[k].dtype == v.dtype and torch.equal(port[k], v), k


@pytest.mark.parametrize("kind", CV.KINDS)
def test_convert_matches_the_jax_route(kind, tmp_path, capsys):
    sd = reference_state_dict(kind)
    port = port_route(kind, sd, tmp_path)
    assert "converted" in capsys.readouterr().out
    assert_same(port, jax_route(kind, sd)[0])


def test_ctrnet_flat_layout_converts_as_the_nested(tmp_path):
    sd = reference_state_dict("ctrnet_seg", seed=3)
    nested, left = ctrnet_seg_state_dict(sd)
    flat, left_flat = ctrnet_seg_state_dict(flat_ctrnet(sd))
    assert not left and not left_flat and sorted(flat) == sorted(nested)
    for k in nested:
        assert torch.equal(flat[k], nested[k]), k
    port = port_route("ctrnet_seg", flat_ctrnet(sd), tmp_path)
    assert_same(port, jax_route("ctrnet_seg", flat_ctrnet(sd))[0])


def test_converted_teacher_forward_matches_jax(tmp_path):
    """The converted CtRNet teacher, port against JAX, at 64x80."""
    sd = reference_state_dict("ctrnet_seg", seed=5)
    _, variables = jax_route("ctrnet_seg", sd)
    model = KeypointSegNet().eval()
    model.load_state_dict(port_route("ctrnet_seg", sd, tmp_path))
    x = np.random.RandomState(6).randn(1, 64, 80, 3).astype(np.float32)
    kp_j, seg_j = jax.jit(lambda v, a: JaxSegNet().apply(v, a, train=False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        kp, seg = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert rel_err(kp.numpy(), np.asarray(kp_j)) <= REL_TOL
    assert rel_err(seg[:, 0].numpy(), np.asarray(seg_j)[..., 0]) <= REL_TOL


def test_stage3_teacher_loader_reads_the_converted_file(tmp_path,
                                                       monkeypatch):
    """`models/panda_segmentation/<camera>.pt`, written by the port's
    converter, is what the stage-3 teacher loader reads, before a
    `.msgpack` beside it."""
    import os

    from horopose_tpu_torch.config import make_cfg
    from horopose_tpu_torch.pipelines.train_sim2real import load_seg_teacher
    cfg = make_cfg(os.path.abspath(os.path.join(
        "configs", "panda", "self_supervised", "azure.yaml")))
    want = port_route("ctrnet_seg", reference_state_dict("ctrnet_seg", 8),
                      tmp_path)
    monkeypatch.chdir(tmp_path)
    folder = tmp_path / "models" / "panda_segmentation"
    folder.mkdir(parents=True)
    torch.save(want, str(folder / "azure.pt"))
    (folder / "azure.msgpack").write_bytes(b"not read")
    got = load_seg_teacher(cfg, device="cpu").model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_reference_pk_loads_through_from_experiment(tmp_path):
    """An experiment directory with the reference's `.pk` ({epoch,
    auc_add, model_state_dict, ...}) serves in the port; `restore_state`
    takes its weights and refuses its optimizer state."""
    sd = reference_state_dict("fullnet", seed=9)
    exp = tmp_path / "exp"
    (exp / "ckpt").mkdir(parents=True)
    (exp / "config.yaml").write_text(yaml.safe_dump(dict(
        backbone_name="resnet18", rootnet_backbone_name="resnet18",
        image_size=float(S))))
    path = exp / "ckpt" / "curr_best_auc(add)_model.pk"
    torch.save({"epoch": 3, "auc_add": 0.5, "model_state_dict": sd,
                "optimizer_state_dict": {}, "lr_scheduler_last_epoch": 3},
               str(path))
    pred = Predictor.from_experiment(str(exp), device="cpu")
    got = pred.model.state_dict()
    assert sorted(got) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(got[k], v), k
    payload = load_checkpoint_file(str(path))
    model = CV.build_target("fullnet", **SMALL)
    restore_state(TrainState(model), payload)
    assert torch.equal(model.state_dict()["final_layer.weight"],
                       sd["final_layer.weight"])
    opt = torch.optim.Adam(model.parameters())
    with pytest.raises(ValueError, match="parameter order"):
        restore_state(TrainState(model, opt), payload)


def test_convert_is_strict(tmp_path):
    """A missing or misshapen tensor raises; a tensor nothing takes is
    listed; an ImageNet HRNet file without the heads converts its trunk."""
    sd = reference_state_dict("resnet18", seed=2)
    model = CV.build_target("resnet18")
    short = {k: v for k, v in sd.items() if k != "layer1.0.conv1.weight"}
    with pytest.raises(ValueError, match="layer1.0.conv1.weight: missing"):
        CV.convert_state_dict("resnet18", short, model)
    bad = dict(sd, **{"conv1.weight": torch.zeros(64, 3, 3, 3)})
    with pytest.raises(ValueError, match="conv1.weight"):
        CV.convert_state_dict("resnet18", bad, model)
    extra = dict(sd, **{"fc.weight": torch.zeros(1000, 512)})
    _, left, absent = CV.convert_state_dict("resnet18", extra, model)
    assert left == ["fc.weight"] and absent == []
    hr = reference_state_dict("hrnet32", seed=4)
    trunk = {k: v for k, v in hr.items()
             if not k.startswith(CV.HRNET_HEADS)}
    out, left, absent = CV.convert_state_dict("hrnet32", trunk,
                                              CV.build_target("hrnet32"))
    assert sorted(out) == sorted(trunk) and not left
    assert absent and all(k.startswith(CV.HRNET_HEADS) for k in absent)
    # the backbone loader takes the trunk-only file as it is
    path = str(tmp_path / "hrnet32.pth")
    torch.save(out, path)
    assert sorted(load_torch_file(path)) == sorted(trunk)
