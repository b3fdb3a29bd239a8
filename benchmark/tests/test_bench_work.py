"""The work counts and peaks the utilisation and roofline metrics divide
by: the frozen FLOPs of each configuration against a fresh count and a
count by hand, the soft-argmax bounds against the kernel table's."""

from __future__ import annotations

import math

import pytest
import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from benchmark import run as bench_run
from benchmark import work
from benchmark.reference.fullnet import reference_model
from benchmark.reference.robot import RobotFK


def _model(config, **overrides):
    c = dict(config, **overrides)
    return reference_model(c, RobotFK(c["urdf_robot_name"]))


def _inputs(B, S):
    f = dict(device="meta")
    x = torch.zeros(B, 3, S, S, **f)
    return x, x, torch.ones(B, **f), torch.eye(3, **f).expand(B, 3, 3)


def _counted(config, train: bool) -> float:
    B, S = 2, int(config["image_size"])
    model = _model(config, p_dropout=0.0)
    model.train(train)
    with FlopCounterMode(display=False) as fc:
        out = model(*_inputs(B, S))
        if train:
            sum(out[k].sum() for k in ("uvd", "pose", "rot", "depth")
                ).backward()
    return fc.get_total_flops() / B


def _by_hand(config) -> float:
    """2 x multiply-adds of every conv, transposed conv and linear layer
    of one image's forward, from the shapes the hooks see."""
    total = []

    def hook(m, inp, out):
        if isinstance(m, nn.Conv2d):
            k = m.in_channels // m.groups * m.kernel_size[0] * m.kernel_size[1]
            total.append(2 * k * out.numel())
        elif isinstance(m, nn.ConvTranspose2d):
            x = inp[0]
            total.append(2 * x.numel() * m.out_channels
                         * m.kernel_size[0] * m.kernel_size[1])
        elif isinstance(m, nn.Linear):
            total.append(2 * m.in_features * out.numel())

    model = _model(config).eval()
    for m in model.modules():
        m.register_forward_hook(hook)
    model(*_inputs(1, int(config["image_size"])))
    return float(sum(total))


@pytest.mark.parametrize("name", ["panda_full", "baxter_full"])
def test_frozen_flops_are_the_counted_ones(name):
    config = bench_run.load_json(bench_run.HERE, "configs", name)
    frozen = config["work"]
    assert _counted(config, False) == pytest.approx(
        frozen["forward_flop_per_image"], rel=1e-9)
    assert _counted(config, True) == pytest.approx(
        frozen["train_flop_per_image"], rel=1e-9)
    # the layers' multiply-adds are all but the soft-argmax's and the
    # camera transforms' few small products
    assert _by_hand(config) == pytest.approx(
        frozen["forward_flop_per_image"], rel=1e-4)


def test_the_two_configurations_differ_only_in_the_head():
    panda, baxter = (bench_run.load_json(bench_run.HERE, "configs", n)
                     ["work"]["forward_flop_per_image"]
                     for n in ("panda_full", "baxter_full"))
    head = 2 * 256 * 64 * 64 * 64 * (17 - 7)     # final_layer's extra rows
    mlp = 2 * (1024 * (15 - 8) + 1024 * (15 - 8)) * 4
    assert baxter - panda == pytest.approx(head + mlp, rel=1e-3)


def test_soft_argmax_bounds_are_the_kernel_tables():
    vol = 64 ** 3
    # PERF.md's kernel table (chip_smoke.py's arithmetic), in ms
    assert 1e3 * work.soft_argmax_fwd_bound_s(128 * 7, vol) == \
        pytest.approx(0.2805, abs=1e-4)
    assert 1e3 * work.soft_argmax_fwd_bound_s(7, vol) == \
        pytest.approx(0.0022, abs=1e-4)
    assert 1e3 * work.soft_argmax_bwd_bound_s(64 * 7, vol) == \
        pytest.approx(0.2805, abs=1e-4)
    assert 1e3 * work.soft_argmax_fwd_bound_s(64 * 7, vol, 2) == \
        pytest.approx(0.0701, abs=1e-4)
    # bytes bound it: 11-12 operations a 4-byte logit is far under the
    # 67 / 3.35 = 20 operations a byte the chip balances at
    assert work.SAM_FWD_OPS / 4 < work.F32_FLOPS / work.HBM_BYTES_PER_S


def test_peaks():
    assert (work.TF32_FLOPS, work.F32_FLOPS, work.BF16_FLOPS,
            work.HBM_BYTES_PER_S) == (495e12, 67e12, 989e12, 3.35e12)
    assert math.isclose(work.BF16_FLOPS / work.TF32_FLOPS, 2.0, rel_tol=1e-2)
