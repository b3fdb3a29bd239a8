"""`cfg.remat` in the port: per-unit recomputation in both backbones, held
against the port without it and against the JAX package's remat FullNet.

The model of `tests/test_remat.py`: resnet18 reg and hrnet32 rootnet
backbones, 32x32 crops, depth_dim 8, B=2, dropout 0. With and without
remat on the same weights: the same state-dict keys, the eval forward at
atol/rtol 1e-6, the train-mode loss at rtol 1e-6, the gradients at atol
2e-5 / rtol 1e-4, and after one step the BatchNorm running statistics at
1e-6 and `num_batches_tracked` exactly (each updated once a step), with
nn.BatchNorm, with SyncBatchNorm in a world-1 gloo group, under
`train_with_frozen_batchnorm` (nothing changes) and under bfloat16
autocast. The units recomputed are the JAX package's: every resnet
block, and HRNet's layer1 and head Bottlenecks and HighResolutionModules,
counted by the forward calls of their first conv in one step. The port's
remat FullNet against the JAX one in train mode: outputs and BatchNorm
statistics at rel 1e-4 on weights carried over by
`fullnet_state_dict_from_jax`, at 96x96 and B=4 (the test says why).
"""

import socket

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from horopose_tpu.models import FullNet as JaxFullNet
from horopose_tpu_torch.config import make_cfg
from horopose_tpu_torch.models import FullNet
from horopose_tpu_torch.models.common import (convert_sync_batchnorm,
                                              train_with_frozen_batchnorm)
from horopose_tpu_torch.models.hrnet import HighResolutionModule
from horopose_tpu_torch.models.resnet import BasicBlock, Bottleneck
from horopose_tpu_torch.pipelines.common import (FullNetConfig, build_fullnet,
                                                 random_state_dict)
from horopose_tpu_torch.tools.jax_weights import fullnet_state_dict_from_jax

from test_torch_port_models import (INIT_POSE, REL_TOL, _inputs, _nchw,
                                    random_jax_variables, rel_err)

S, D, B = 32, 8, 2
KW = dict(backbone_name="resnet18", rootnet_backbone_name="hrnet32",
          image_size=S, depth_dim=D, p_dropout=0.0, init_pose=INIT_POSE)
FWD_TOL = 1e-6
LOSS_RTOL = 1e-6
GRAD_ATOL, GRAD_RTOL = 2e-5, 1e-4
STAT_TOL = 1e-6
JAX_SIZE = (96, 4)        # crop side, batch of the JAX comparison
UNITS = (BasicBlock, Bottleneck, HighResolutionModule)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(seed=0):
    """A FullNet without remat and one with it, on the same weights."""
    m0 = FullNet(**KW)
    m0.load_state_dict(random_state_dict(m0, seed))
    m1 = FullNet(**KW, remat=True)
    m1.load_state_dict(m0.state_dict())
    return m0, m1


def _args(seed=808):
    x_reg, x_root, k, K = _inputs(np.random.RandomState(seed), B, S)
    return (_nchw(x_reg), _nchw(x_root), torch.from_numpy(k),
            torch.from_numpy(K))


def _loss(out):
    return (out["pose"].sum() + out["rot"].sum() + out["xyz_int"].sum()
            + out["depth"].sum())


def _step(model, args, autocast=False):
    """One train-mode forward and backward: (loss, grads, state dict)."""
    model.zero_grad(set_to_none=True)
    with torch.autocast("cpu", dtype=torch.bfloat16, enabled=autocast):
        loss = _loss(model(*args))
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    return (loss.detach(), grads,
            {k: v.clone() for k, v in model.state_dict().items()})


def _assert_same_step(a, b):
    (l0, g0, s0), (l1, g1, s1) = a, b
    np.testing.assert_allclose(l1.float().numpy(), l0.float().numpy(),
                               rtol=LOSS_RTOL)
    assert sorted(g0) == sorted(g1) and len(g0) > 0
    for k in g0:
        np.testing.assert_allclose(g1[k].numpy(), g0[k].numpy(),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=k)
    for k in s0:
        if k.endswith("num_batches_tracked"):
            assert torch.equal(s1[k], s0[k]), k
        else:
            np.testing.assert_allclose(s1[k].numpy(), s0[k].numpy(),
                                       atol=STAT_TOL, rtol=STAT_TOL,
                                       err_msg=k)


def test_remat_keeps_the_state_dict_keys():
    """A remat checkpoint loads into a model without remat and back."""
    m0, m1 = _pair()
    assert list(m0.state_dict()) == list(m1.state_dict())
    FullNet(**KW).load_state_dict(m1.state_dict(), strict=True)
    FullNet(**KW, remat=True).load_state_dict(m0.state_dict(), strict=True)


def test_eval_forward_is_unchanged():
    m0, m1 = _pair()
    args = _args()
    with torch.no_grad():
        o0, o1 = m0.eval()(*args), m1.eval()(*args)
    for k in o0:
        np.testing.assert_allclose(o1[k].numpy(), o0[k].numpy(),
                                   atol=FWD_TOL, rtol=FWD_TOL, err_msg=k)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture
def world1_gloo():
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mode", ["batchnorm", "frozen", "bf16_autocast"])
def test_train_step_with_remat_matches_without(mode):
    """Loss, gradients and the statistics after one step; the statistics
    moved once (from the loaded ones) unless frozen."""
    m0, m1 = _pair()
    before = {k: v.clone() for k, v in m0.state_dict().items()}
    for m in (m0, m1):
        train_with_frozen_batchnorm(m) if mode == "frozen" else m.train()
    args = _args()
    a = _step(m0, args, autocast=mode == "bf16_autocast")
    b = _step(m1, args, autocast=mode == "bf16_autocast")
    _assert_same_step(a, b)
    tracked = [k for k in before if k.endswith("num_batches_tracked")]
    for k in tracked:
        want = before[k] + (0 if mode == "frozen" else 1)
        assert torch.equal(b[2][k], want), k
    if mode == "frozen":
        for k in before:
            assert torch.equal(b[2][k], before[k]), k


def test_train_step_with_remat_matches_without_sync_batchnorm(world1_gloo):
    """SyncBatchNorm (the data-parallel BatchNorm) in a world-1 gloo
    group: the same agreement, each statistic updated once."""
    assert dist.get_world_size() == 1
    m0, m1 = (convert_sync_batchnorm(m).train() for m in _pair())
    args = _args()
    a, b = _step(m0, args), _step(m1, args)
    _assert_same_step(a, b)
    for k, v in b[2].items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == 1, k


def _jax_units(model):
    """Names of the units the JAX package's remat wraps: every block of a
    resnet backbone; HRNet's layer1 and head (incre) Bottlenecks and its
    HighResolutionModules (not their BasicBlocks, the stem or the
    transitions)."""
    names = set()
    for name, m in model.named_modules():
        if isinstance(m, HighResolutionModule) or (
                isinstance(m, (BasicBlock, Bottleneck))
                and ".branches." not in name):
            names.add(name)
    return names


def _flagged(model):
    return {n for n, m in model.named_modules() if getattr(m, "remat", False)}


def _first_conv_calls(model, args):
    """{unit name: forward calls of the unit's first conv in one train
    step}, for every resnet block, Bottleneck and HighResolutionModule."""
    counts, hooks = {}, []
    for name, m in model.named_modules():
        if isinstance(m, UNITS):
            first = next(c for c in m.modules()
                         if isinstance(c, torch.nn.Conv2d))
            counts[name] = 0

            def hook(*_, name=name):
                counts[name] += 1
            hooks.append(first.register_forward_hook(hook))
    _step(model.train(), args)
    for h in hooks:
        h.remove()
    return counts


def test_remat_recomputes_the_units_jax_wraps():
    """Without remat each unit runs once a step; with it, the JAX units
    run twice (forward and recompute), and so do the BasicBlocks inside a
    recomputed HighResolutionModule, once in each of its passes."""
    m0, m1 = _pair()
    args = _args()
    assert set(_first_conv_calls(m0, args).values()) == {1}
    units = _jax_units(m1)
    # 2 + 2 + 2 + 2 resnet18 blocks; 4 layer1, 4 incre, 1 + 4 + 3 modules
    assert len(units) == 8 + 4 + 4 + 1 + 4 + 3
    assert _flagged(m1) == units
    counts = _first_conv_calls(m1, args)
    assert set(counts.values()) == {2}
    assert set(counts) - units == {n for n in counts if ".branches." in n}


def test_make_cfg_remat_builds_wrapped_units(tmp_path):
    """`remat : True` in a YAML reaches the JAX units of both backbones
    through FullNetConfig.from_cfg and build_fullnet; `False` wraps
    none."""
    path = tmp_path / "remat.yaml"
    path.write_text('backbone_name : "resnet18"\n'
                    'rootnet_backbone_name : "hrnet32"\n'
                    "image_size : 32.0\nremat : True\n")
    cfg = make_cfg(str(path))
    assert cfg.remat is True
    fcfg = FullNetConfig.from_cfg(cfg)
    assert fcfg.remat is True
    model = build_fullnet(fcfg)
    assert _flagged(model) == _jax_units(model) != set()
    path.write_text(path.read_text().replace("True", "False"))
    plain = build_fullnet(FullNetConfig.from_cfg(make_cfg(str(path))))
    assert _flagged(plain) == set()


def test_remat_fullnet_matches_the_jax_remat_fullnet():
    """Train mode, batch statistics: the outputs and the updated BatchNorm
    statistics of the JAX remat FullNet and the port's, at 96x96 and B=4
    (JAX_SIZE): at 32x32 and B=2 HRNet's last reductions hold 2 values,
    whose normalised values are +-1 and flip sign with f32 rounding in
    either package. The depth head is conditioned as in
    tests/test_torch_port_engine.py (kernel x 1e-3, bias 1: about a metre
    for k = 1000), else its 2048-term sum cancels and magnifies rounding."""
    S, B = JAX_SIZE
    kw = dict(KW, image_size=S)
    jmodel = JaxFullNet(**kw, remat=True)
    args = _inputs(np.random.RandomState(808), B, S)
    variables = random_jax_variables(jmodel, args, 3)
    head = variables["params"]["depth_layer"]
    head["kernel"] = head["kernel"] * 1e-3
    head["bias"] = np.ones_like(head["bias"])
    ref, mut = jax.jit(lambda v, *a: jmodel.apply(
        v, *a, train=True, rngs={"dropout": jax.random.PRNGKey(0)},
        mutable=["batch_stats"]))(variables, *args)
    model = FullNet(**kw, remat=True)
    model.load_state_dict(fullnet_state_dict_from_jax(
        variables["params"], variables["batch_stats"], "resnet18",
        "hrnet32"))
    model.train()
    x_reg, x_root, k, K = args
    out = model(_nchw(x_reg), _nchw(x_root), torch.from_numpy(k),
                torch.from_numpy(K))
    _loss(out).backward()            # the recompute runs here
    for key in ("pose", "rot", "trans", "depth", "uvd", "xyz_int"):
        assert rel_err(out[key].detach().numpy(), ref[key]) <= REL_TOL, key
    want = fullnet_state_dict_from_jax(
        variables["params"], jax.tree.map(np.asarray, mut["batch_stats"]),
        "resnet18", "hrnet32")
    got = model.state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) > 100
    for k in stats:
        assert rel_err(got[k].numpy(), want[k].numpy()) <= REL_TOL, k
