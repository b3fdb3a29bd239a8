"""The serving artifact (`tools/export.py`) and the registered soft-argmax
operators (`ops/integral.py`), on the CPU, at the JAX `tests/test_export.py`
size (resnet18 + resnet18, 64 px crops, 32 px root crops, depth_dim 8,
b=2): the exported program after `torch.export.save` / `load` against the
eager serving module and the JAX `build_serving_fn`, the meta, the CLI,
and the operators' gradient, fake and autograd registrations."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from horopose_tpu.config import make_default_cfg as jax_default_cfg
from horopose_tpu.tools.export import build_serving_fn
from horopose_tpu_torch.core.checkpoint import (TrainState,
                                                save_checkpoint_file)
from horopose_tpu_torch.ops import integral as TI
from horopose_tpu_torch.pipelines.common import (FullNetConfig, build_fullnet,
                                                 random_state_dict)
from horopose_tpu_torch.tools import export as EX
from horopose_tpu_torch.tools.jax_weights import fullnet_state_dict_from_jax

from test_torch_port_models import random_jax_variables, rel_err

B = 2
REL_TOL = 1e-4
CFG = FullNetConfig(backbone_name="resnet18", rootnet_backbone_name="resnet18",
                    image_size=64, rootnet_image_size=32, depth_dim=8)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small(monkeypatch_module):
    """The JAX config and variables (numpy values on the eval_shape tree)
    and the port's state dict of the same weights."""
    import horopose_tpu.pipelines.common as JC
    build = JC.build_fullnet
    # depth_dim is not a config key: the JAX model is cloned to 8
    monkeypatch_module.setattr(JC, "build_fullnet",
                               lambda cfg: build(cfg).clone(depth_dim=8))
    jcfg = jax_default_cfg()
    jcfg.update(image_size=64.0, rootnet_image_size=32.0,
                backbone_name="resnet18", rootnet_backbone_name="resnet18")
    variables = random_jax_variables(
        JC.build_fullnet(jcfg),
        (np.zeros((1, 64, 64, 3), np.float32),
         np.zeros((1, 32, 32, 3), np.float32), np.ones((1,), np.float32),
         np.eye(3, dtype=np.float32)[None]), seed=31)
    sd = fullnet_state_dict_from_jax(variables["params"],
                                     variables["batch_stats"], "resnet18",
                                     "resnet18")
    return jcfg, variables, sd


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _inputs(seed=7):
    r = np.random.RandomState(seed)
    x = r.randint(0, 255, (B, 64, 64, 3), dtype=np.uint8)
    xr = r.randint(0, 255, (B, 32, 32, 3), dtype=np.uint8)
    k = np.full((B,), 1200.0, np.float32)
    K = np.tile(np.asarray([[80.0, 0, 32], [0, 80.0, 32], [0, 0, 1]],
                           np.float32)[None], (B, 1, 1))
    return x, xr, k, K


def test_exported_program_matches_eager_and_jax(small, tmp_path):
    jcfg, variables, sd = small
    path = str(tmp_path / "model.pt2")
    meta = EX.export_serving(CFG, sd, path, batch_size=B, device="cpu")
    fn, loaded = EX.load_serving(path, device="cpu")
    assert loaded == meta
    args = tuple(torch.from_numpy(a) for a in _inputs())
    out = fn(*args)
    assert list(out) == list(EX.OUTPUTS)
    assert out["pose"].shape == (B, 8) and out["xyz_fk"].shape == (B, 7, 3)
    with torch.no_grad():
        eager = EX.build_serving_module(CFG, sd, device="cpu").outputs(*args)
    direct, _ = build_serving_fn(jcfg, variables=variables)
    ref = direct(*(jnp.asarray(a) for a in _inputs()))
    assert set(ref) == set(out)
    for key in EX.OUTPUTS:
        assert rel_err(out[key].numpy(), eager[key].numpy()) <= REL_TOL, key
        assert rel_err(out[key].numpy(), np.asarray(ref[key])) <= REL_TOL, \
            key


def test_export_meta_and_cli_round_trip(small, tmp_path, capsys):
    """`python -m horopose_tpu_torch.tools.export` (main in this process)
    on a port experiment: the JAX meta's keys with `device` in place of
    `platforms`, read back by `load_serving`, which refuses another device
    type."""
    exp = tmp_path / "exp"
    (exp / "ckpt").mkdir(parents=True)
    (exp / "config.yaml").write_text(yaml.safe_dump(dict(
        backbone_name="resnet18", rootnet_backbone_name="resnet18",
        image_size=64.0, rootnet_image_size=32.0, reference_keypoint_id=3)))
    cfg = dataclasses.replace(CFG, depth_dim=64)   # 64: not a config key
    model = build_fullnet(cfg)
    model.load_state_dict(random_state_dict(model, 5))
    save_checkpoint_file(str(exp / "ckpt" / "curr_best_auc(add)_model.pk"),
                         epoch=1, metric=0.5, state=TrainState(model))
    path = str(tmp_path / "cli.pt2")
    assert EX.main([str(exp), path, "--batch_size", str(B), "--device",
                    "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "MB" in printed
    meta = json.loads(printed[printed.index("{"):])
    fn, loaded = EX.load_serving(path, device="cpu")
    assert loaded == meta
    jax_keys = {"batch_size", "other_hw", "rootnet_hw", "robot", "dof",
                "num_keypoints", "reference_keypoint_id", "compute_dtype",
                "inputs"}
    assert jax_keys | {"device", "outputs"} == set(meta)
    assert meta["batch_size"] == B and meta["device"] == "cpu"
    assert meta["other_hw"] == [64, 64] and meta["rootnet_hw"] == [32, 32]
    assert meta["dof"] == 8 and meta["num_keypoints"] == 7
    assert meta["reference_keypoint_id"] == 3
    assert meta["compute_dtype"] == "float32"
    out = fn(*(torch.from_numpy(a) for a in _inputs(3)))
    assert all(torch.isfinite(v).all() for v in out.values())
    with pytest.raises(ValueError, match="exported for cpu"):
        EX.load_serving(path, device="cuda")


def test_soft_argmax_op_gradient_matches_plain():
    """The registered forward and its registered gradient on the CPU: the
    plain version's values, and `gradcheck` in float64 on a tiny cell."""
    torch.manual_seed(0)
    x = torch.randn(3, 4, 5, 6) * 3
    g = torch.randn(3, 3)
    xo = x.clone().requires_grad_()
    uvd, ex, stats = TI.soft_argmax_3d_op(xo)
    assert not ex.requires_grad and not stats.requires_grad
    (uvd * g).sum().backward()
    want = TI.soft_argmax_3d_fwd_plain(x)
    for got, ref in zip((uvd, ex, stats), want):
        assert torch.equal(got.detach(), ref)
    xp = x.clone().requires_grad_()
    (TI.soft_argmax_3d_fwd_plain(xp)[0] * g).sum().backward()
    torch.testing.assert_close(xo.grad, xp.grad, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(
        xo.grad, TI.soft_argmax_3d_bwd_plain(x, want[1], want[2], g))
    x64 = torch.randn(2, 2, 3, 4, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda t: TI.soft_argmax_3d_op(t)[0], (x64,))


def test_soft_argmax_ops_pass_opcheck():
    """`torch.library.opcheck`: the schema, the fake implementation (the
    shapes and dtypes of the real one), the autograd registration, and
    tracing with dynamic shapes."""
    torch.manual_seed(1)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(3, 4, 5, 6).to(dtype)
        torch.library.opcheck(TI.soft_argmax_3d_op,
                              (x.clone().requires_grad_(),))
        _, ex, stats = TI.soft_argmax_3d_op(x)
        torch.library.opcheck(TI.soft_argmax_3d_bwd_op,
                              (x, ex, stats, torch.randn(3, 3)))
