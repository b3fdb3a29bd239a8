"""Port models against the JAX package.

The flagship FullNet (resnet50 reg + hrnet32 rootnet) at image_size 64 and
depth_dim 8: the JAX variables are made from a numpy seed on the tree that
`FullNet.init` would build (traced with `jax.eval_shape`, no compile), BN
running statistics included, then carried into the port with
`fullnet_state_dict_from_jax`. Both run in eval mode on the same crops.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horopose_tpu import constants as JC
from horopose_tpu.models import FullNet as JaxFullNet
from horopose_tpu.tools.torch_weights import \
    convert_fullnet_reference_checkpoint
from horopose_tpu_torch.models import FullNet
from horopose_tpu_torch.pipelines.common import random_state_dict
from horopose_tpu_torch.tools.jax_weights import fullnet_state_dict_from_jax

# the f32 bound the repo's parity tests use, relative to the output's max
REL_TOL = 1e-4
OUTPUT_KEYS = ["pose", "rot", "trans", "root_uv", "depth", "uvd", "xyz_int"]
INIT_POSE = tuple(JC.initial_joint_vector("mean", "panda").tolist())


def rel_err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-6))


def random_jax_variables(model, args, seed):
    """Variables of `model` with numpy-random values: He-normal kernels,
    small biases, BN scale near 0.5 (keeps activations O(1)), random BN
    running mean and var."""
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
        *args, train=False))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "var":
            v = 0.5 + rng.rand(*s.shape)
        elif name == "mean":
            v = 0.1 * rng.randn(*s.shape)
        elif name == "scale":
            v = 0.5 + 0.05 * rng.randn(*s.shape)
        elif name == "bias":
            v = 0.01 * rng.randn(*s.shape)
        else:
            v = rng.randn(*s.shape) * np.sqrt(2.0 / np.prod(s.shape[:-1]))
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _inputs(rng, B, S):
    x_reg = rng.rand(B, S, S, 3).astype(np.float32)
    x_root = rng.rand(B, S, S, 3).astype(np.float32)
    k_value = rng.uniform(1000, 3000, B).astype(np.float32)
    K = np.tile(np.asarray([[300.0, 0, S / 2], [0, 310.0, S / 2], [0, 0, 1]],
                           np.float32)[None], (B, 1, 1))
    K[:, 0, 2] += rng.uniform(-3, 3, B)
    return x_reg, x_root, k_value, K


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def flagship():
    S, D, B = 64, 8, 2
    jmodel = JaxFullNet(image_size=S, depth_dim=D, p_dropout=0.0,
                        init_pose=INIT_POSE)
    x_reg, x_root, k_value, K = _inputs(np.random.RandomState(808), B, S)
    variables = random_jax_variables(jmodel, (x_reg, x_root, k_value, K), 1)
    ref = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=False))(
        variables, x_reg, x_root, k_value, K)
    model = FullNet(image_size=S, depth_dim=D, p_dropout=0.0,
                    init_pose=INIT_POSE)
    model.load_state_dict(fullnet_state_dict_from_jax(
        variables["params"], variables["batch_stats"], "resnet50", "hrnet32"))
    model.eval()
    with torch.no_grad():
        out = model(_nchw(x_reg), _nchw(x_root), torch.from_numpy(k_value),
                    torch.from_numpy(K))
    return ({k: np.asarray(v) for k, v in ref.items()},
            {k: v.numpy() for k, v in out.items()})


@pytest.mark.parametrize("key", OUTPUT_KEYS)
def test_flagship_fullnet_matches_jax(flagship, key):
    ref, out = flagship
    assert out[key].shape == ref[key].shape
    assert np.isfinite(out[key]).all()
    assert rel_err(out[key], ref[key]) <= REL_TOL, key


def test_hrnet_reg_resnet_rootnet_fullnet_matches_jax(rng):
    """The other backbone wiring: hrnet32 as the reg backbone (heatmap and
    feature heads from one HRNet) and a resnet rootnet (GAP feature)."""
    S, D, B = 64, 4, 2
    kw = dict(backbone_name="hrnet32", rootnet_backbone_name="resnet18",
              image_size=S, depth_dim=D, p_dropout=0.0, init_pose=INIT_POSE)
    jmodel = JaxFullNet(**kw)
    args = _inputs(rng, B, S)
    variables = random_jax_variables(jmodel, args, 2)
    ref = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=False))(
        variables, *args)
    model = FullNet(**kw)
    model.load_state_dict(fullnet_state_dict_from_jax(
        variables["params"], variables["batch_stats"], "hrnet32",
        "resnet18"))
    model.eval()
    x_reg, x_root, k_value, K = args
    with torch.no_grad():
        out = model(_nchw(x_reg), _nchw(x_root), torch.from_numpy(k_value),
                    torch.from_numpy(K))
    for key in OUTPUT_KEYS:
        assert rel_err(out[key].numpy(), ref[key]) <= REL_TOL, key


@pytest.mark.parametrize("backbone,rootnet", [("resnet50", "hrnet32"),
                                              ("resnet18", "resnet34"),
                                              ("hrnet32", "resnet50")])
def test_state_dict_round_trips_through_jax_layout(backbone, rootnet):
    """port state_dict -> convert_fullnet_reference_checkpoint (the JAX
    package's torch -> flax map) -> fullnet_state_dict_from_jax gives back
    every key, bit for bit."""
    model = FullNet(backbone_name=backbone, rootnet_backbone_name=rootnet,
                    image_size=64, depth_dim=8, init_pose=INIT_POSE)
    sd = {k: v.numpy() for k, v in random_state_dict(model, 3).items()
          if not k.endswith("num_batches_tracked")}
    tb = convert_fullnet_reference_checkpoint(sd, backbone, rootnet)
    back = fullnet_state_dict_from_jax(tb.params, tb.batch_stats, backbone,
                                       rootnet)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    model.load_state_dict(back)      # strict: every module key is present


def test_from_jax_rejects_leaves_without_a_torch_key():
    model = FullNet(backbone_name="resnet18", rootnet_backbone_name="resnet18",
                    image_size=64, depth_dim=8, init_pose=INIT_POSE)
    sd = {k: v.numpy() for k, v in random_state_dict(model, 0).items()}
    tb = convert_fullnet_reference_checkpoint(sd, "resnet18", "resnet18")
    tb.params["stray_head"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="stray_head"):
        fullnet_state_dict_from_jax(tb.params, tb.batch_stats, "resnet18",
                                    "resnet18")


FLAG_NEEDS = {"multi_kp": dict(kps_need_depth=(0, 3, 6)),
              "reg_joint_map": dict(joint_bounds=JC.JOINT_BOUNDS["panda"])}


@pytest.mark.parametrize("flag", ["multi_kp", "add_fc", "reg_joint_map",
                                  "direct_reg_rot", "rot_iterative_matmul"])
def test_unported_flags_raise(flag):
    """Every flag is ported now (the name is kept from when each raised):
    each builds with what it needs, runs a forward, and raises a
    ValueError where the JAX model would fail. The variants' parity with
    JAX is in tests/test_torch_port_variants.py."""
    kw = dict(backbone_name="resnet18", rootnet_backbone_name="resnet18",
              image_size=64, depth_dim=4, init_pose=INIT_POSE)
    model = FullNet(**kw, **{flag: True}, **FLAG_NEEDS.get(flag, {}))
    model.load_state_dict(random_state_dict(model, 0))
    with torch.no_grad():
        out = model.eval()(torch.rand(1, 3, 64, 64), torch.rand(1, 3, 64, 64),
                           torch.full((1,), 2000.0), torch.eye(3)[None])
    assert all(torch.isfinite(v).all() for v in out.values())
    assert ("depths" in out) == (flag == "multi_kp")
    bad = {"multi_kp": dict(kps_need_depth=(0, 1)),      # no root keypoint
           "reg_joint_map": {},                          # no joint bounds
           "rot_iterative_matmul": dict(rotation_dim=4,
                                        init_rot=(1, 0, 0, 0)),
           "direct_reg_rot": dict(rotation_dim=9),       # 6 init_rot values
           "add_fc": dict(dtype=torch.float16)}[flag]
    with pytest.raises(ValueError):
        FullNet(**kw, **{flag: True, **bad})


def test_bf16_forward_keeps_heads_and_decoding_f32(rng):
    model = FullNet(backbone_name="resnet18", rootnet_backbone_name="resnet18",
                    image_size=64, depth_dim=8, init_pose=INIT_POSE,
                    dtype=torch.bfloat16)
    model.load_state_dict(random_state_dict(model, 0))
    model.eval()
    seen = {}

    def record(name):
        def hook(_module, _inputs, output):
            seen[name] = output.dtype
        return hook

    model.final_layer.register_forward_hook(record("heatmap"))
    model.depth_layer.register_forward_hook(record("depth_layer"))
    x_reg, x_root, k_value, K = _inputs(rng, 2, 64)
    with torch.no_grad():
        out = model(_nchw(x_reg), _nchw(x_root), torch.from_numpy(k_value),
                    torch.from_numpy(K))
    assert seen == {"heatmap": torch.bfloat16, "depth_layer": torch.float32}
    for key in OUTPUT_KEYS:
        assert out[key].dtype == torch.float32, key
        assert torch.isfinite(out[key]).all(), key


def test_train_mode_dropout_draws_from_the_step_generator(rng):
    """Train mode: batch-statistics BatchNorm and dropout masks from the
    generator the step passes (the same seed gives the same masks, the
    global generator is not read); eval mode is deterministic and takes
    no generator."""
    model = FullNet(backbone_name="resnet18", rootnet_backbone_name="resnet18",
                    image_size=64, depth_dim=8, init_pose=INIT_POSE,
                    p_dropout=0.5)
    model.load_state_dict(random_state_dict(model, 0))
    args = [torch.from_numpy(a) if a.ndim < 4 else _nchw(a)
            for a in _inputs(rng, 2, 64)]
    model.train()
    with torch.no_grad():
        outs = []
        for seed in (1, 1, 2):
            torch.manual_seed(seed + 100)       # the global generator moves
            outs.append(model(*args,
                              generator=torch.Generator().manual_seed(seed)))
        with pytest.raises(ValueError, match="generator"):
            model(*args)
        model.eval()
        ev = [model(*args)["pose"] for _ in range(2)]
    for key in ("pose", "rot"):
        assert torch.equal(outs[0][key], outs[1][key]), key
        assert not torch.equal(outs[0][key], outs[2][key]), key
    assert torch.equal(ev[0], ev[1])
    assert not torch.equal(ev[0], outs[0]["pose"])


def test_dropout_masks_keep_one_minus_p_and_rescale():
    model = FullNet(backbone_name="resnet18", rootnet_backbone_name="resnet18",
                    image_size=64, depth_dim=8, init_pose=INIT_POSE,
                    p_dropout=0.3).train()
    x = torch.ones(200, 1000)
    y = model._drop(x, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.7))


def _init_jax(jmodel, args):
    return jax.jit(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        *args, train=False))()


def test_fresh_fullnet_follows_the_jax_initializers():
    """A fresh port FullNet draws each tensor as the JAX model's init does
    (flax's lecun-normal kernels, zero biases, the heads' own
    initialisers): the same zeros and ones, and each other tensor of 64+
    entries at the JAX tensor's spread (std within 15%, or 30% under
    1000 entries; torch's defaults are at 58% with non-zero biases)."""
    torch.manual_seed(0)
    kw = dict(backbone_name="resnet18", rootnet_backbone_name="resnet18",
              image_size=32, depth_dim=8, init_pose=INIT_POSE)
    v = _init_jax(JaxFullNet(**kw), _inputs(np.random.RandomState(0), 2, 32))
    ref = fullnet_state_dict_from_jax(v["params"], v["batch_stats"],
                                      "resnet18", "resnet18")
    ours = FullNet(**kw).state_dict()
    assert sorted(ref) == sorted(
        k for k in ours if not k.endswith("num_batches_tracked"))
    spread = 0
    for key, want in ref.items():
        got, want = ours[key].double(), want.double()
        for const in (0.0, 1.0):
            if bool((want == const).all()):
                assert bool((got == const).all()), (key, const)
                break
        else:
            if want.numel() >= 64:
                ratio = float(got.std() / want.std())
                tol = 0.15 if want.numel() >= 1000 else 0.30
                assert abs(ratio - 1.0) <= tol, (key, ratio)
                spread += 1
    assert spread > 20
