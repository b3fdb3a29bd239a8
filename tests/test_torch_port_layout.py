"""The FullNet's memory format: its conv stacks hold weights and
activations in `torch.channels_last`, from the normalisers to the heatmap.

Forward pre-hooks on every Conv2d, ConvTranspose2d and BatchNorm2d of a
panda and a baxter FullNet at the published widths (resnet50 + hrnet32,
depth_dim 64) see a channels_last input on the serving call, the stage-2
train step and the eval step; after the step the conv weights' gradients
and Adam's moments are channels_last too. The counter
`fullnet.input_relayouts` reads no copy on each path. Weights keep their format and values through a
checkpoint, a state dict of any layout and the JAX converter, and a
seeded FullNet draws the values it drew before the format changed.
"""

from __future__ import annotations

import copy
import hashlib

import numpy as np
import pytest
import torch
from torch import nn

from horopose_tpu.tools.torch_weights import \
    convert_fullnet_reference_checkpoint
from horopose_tpu_torch import constants as C
from horopose_tpu_torch.core import profiling
from horopose_tpu_torch.core.checkpoint import (TrainState,
                                                load_checkpoint_file,
                                                restore_state,
                                                save_checkpoint_file)
from horopose_tpu_torch.core.engine import (build_full_eval_step,
                                            build_full_train_step,
                                            make_optimizer)
from horopose_tpu_torch.data.synthetic import synthetic_dream_batch
from horopose_tpu_torch.models import FullNet
from horopose_tpu_torch.pipelines.common import (FullNetConfig, build_fullnet,
                                                 make_robot,
                                                 random_state_dict)
from horopose_tpu_torch.tools.export import ServingModule
from horopose_tpu_torch.tools.jax_weights import fullnet_state_dict_from_jax
from _torch_port_threads import one_intra_op_thread  # noqa: F401

CL = torch.channels_last
S, B = 64, 2
ROBOTS = ("panda", "baxter")
LAYERS = (nn.Conv2d, nn.ConvTranspose2d, nn.BatchNorm2d)
SMALL = dict(backbone_name="resnet18", rootnet_backbone_name="resnet18",
             image_size=32, depth_dim=8,
             init_pose=tuple(C.initial_joint_vector("mean", "panda").tolist()))
# sha256 over (key, values in logical order) of SMALL's state dict after
# torch.manual_seed(0): what the model drew while it was NCHW
SEEDED_DIGEST = \
    "0714dadd073145c526ab26f9b968f776a59f09736ac3828dcca725b9799db69b"


def _cfg(robot: str) -> FullNetConfig:
    return FullNetConfig(urdf_robot_name=robot, image_size=S)


@pytest.fixture(scope="module")
def nets():
    """{robot: (cfg, a seeded FullNet at the published widths, its robot,
    a synthetic batch)}; each test works on a copy of the model."""
    out = {}
    for i, robot in enumerate(ROBOTS):
        cfg = _cfg(robot)
        torch.manual_seed(i)
        rb = make_robot(cfg, device="cpu")
        out[robot] = (cfg, build_fullnet(cfg), rb,
                      synthetic_dream_batch(rb, B, S, S, 7 + i, device="cpu"))
    return out


class LayoutProbe:
    """Forward pre-hooks on every conv and BatchNorm of `model` that note
    each input not channels_last-contiguous; `relayouts` the FullNet's
    crop copies since the probe was made."""

    def __init__(self, model: nn.Module):
        self.seen, self.nchw = 0, []
        self.handles = [m.register_forward_pre_hook(self._hook(name))
                        for name, m in model.named_modules()
                        if isinstance(m, LAYERS)]
        assert len(self.handles) > 300
        self.before = dict(profiling.counters)

    def _hook(self, name):
        def hook(module, args):
            self.seen += 1
            if not args[0].is_contiguous(memory_format=CL):
                self.nchw.append((name, tuple(args[0].stride())))
        return hook

    def relayouts(self) -> int:
        return profiling.counter_deltas(self.before).get(
            "fullnet.input_relayouts", 0)

    def close(self):
        for h in self.handles:
            h.remove()


def _not_channels_last(tensors) -> list:
    return [k for k, t in tensors if t.dim() == 4
            and not t.is_contiguous(memory_format=CL)]


@pytest.mark.parametrize("robot", ROBOTS)
def test_serving_call_stays_channels_last(nets, robot):
    cfg, base, rb, batch = nets[robot]
    serving = ServingModule(copy.deepcopy(base), rb, cfg.reference_keypoint_id)
    probe = LayoutProbe(serving.model)
    with torch.no_grad():
        out = serving.outputs(batch["other"]["images"],
                              batch["root"]["images"],
                              torch.full((B,), 1500.0), batch["other"]["K"])
    probe.close()
    assert probe.seen and probe.nchw == [], probe.nchw[:5]
    assert probe.relayouts() == 0
    assert torch.isfinite(out["xyz_fk"]).all()


@pytest.mark.parametrize("robot", ROBOTS)
def test_train_step_stays_channels_last(nets, robot):
    """One stage-2 step, forward and backward: every conv and BatchNorm
    input channels_last, and after it the 4-D weights, their gradients
    and Adam's two moments."""
    cfg, base, rb, batch = nets[robot]
    model = copy.deepcopy(base)
    opt, sched = make_optimizer(cfg, model.parameters(), 10)
    step = build_full_train_step(cfg, model, rb, opt, sched)
    probe = LayoutProbe(model)
    logs = step(batch, torch.Generator().manual_seed(3))
    probe.close()
    assert probe.seen and probe.nchw == [], probe.nchw[:5]
    assert probe.relayouts() == 0
    assert torch.isfinite(logs["loss"])
    params = list(model.named_parameters())
    assert sum(p.dim() == 4 for _, p in params) > 300
    assert _not_channels_last(params) == []
    assert _not_channels_last((k, p.grad) for k, p in params) == []
    for moment in ("exp_avg", "exp_avg_sq"):
        assert _not_channels_last((k, opt.state[p][moment])
                                  for k, p in params) == [], moment


@pytest.mark.parametrize("robot", ROBOTS)
def test_eval_step_stays_channels_last(nets, robot):
    cfg, base, rb, batch = nets[robot]
    model = copy.deepcopy(base)
    probe = LayoutProbe(model)
    preds, _, logs = build_full_eval_step(cfg, model, rb)(batch)
    probe.close()
    assert probe.seen and probe.nchw == [], probe.nchw[:5]
    assert probe.relayouts() == 0
    assert torch.isfinite(logs["loss"])


@pytest.mark.parametrize("nchw,relayouts", [(("reg",), 1), (("root",), 1),
                                             (("reg", "root"), 2)],
                         ids=["reg", "root", "both"])
def test_nchw_crops_are_copied_once_to_the_same_outputs(nets, nchw,
                                                        relayouts):
    """An NCHW-contiguous crop is copied into channels_last once per
    forward, counted, and gives the outputs of the channels_last crop bit
    for bit."""
    cfg, base, _, batch = nets["panda"]
    model = copy.deepcopy(base).eval()
    crops = {name: batch[key]["images"].permute(0, 3, 1, 2).float() / 255.0
             for name, key in (("reg", "other"), ("root", "root"))}
    assert all(x.is_contiguous(memory_format=CL) for x in crops.values())
    args = (torch.full((B,), 1500.0), batch["other"]["K"])
    with torch.no_grad():
        want = model(crops["reg"], crops["root"], *args)
        given = {name: x.contiguous() if name in nchw else x
                 for name, x in crops.items()}
        probe = LayoutProbe(model)
        got = model(given["reg"], given["root"], *args)
    probe.close()
    assert probe.nchw == [], probe.nchw[:5]
    assert probe.relayouts() == relayouts
    for key, value in want.items():
        assert torch.equal(got[key], value), key


def _assert_same_channels_last(model: nn.Module, want: dict):
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert _not_channels_last(model.named_parameters()) == []


def test_checkpoint_round_trip_keeps_channels_last(tmp_path):
    """A channels_last FullNet's checkpoint, with its Adam state, loads
    into a fresh model and optimizer with the same values and keys, the
    weights and moments channels_last."""
    torch.manual_seed(1)
    model = FullNet(**SMALL)
    opt = torch.optim.Adam(model.parameters())
    for p in model.parameters():
        p.grad = torch.randn_like(p)
    opt.step()
    path = str(tmp_path / "ckpt.pt")
    save_checkpoint_file(path, epoch=0, metric=0.0,
                         state=TrainState(model, opt))
    fresh = FullNet(**SMALL)
    fresh_opt = torch.optim.Adam(fresh.parameters())
    restore_state(TrainState(fresh, fresh_opt), load_checkpoint_file(path))
    _assert_same_channels_last(fresh, model.state_dict())
    for p, q in zip(model.parameters(), fresh.parameters()):
        for moment in ("exp_avg", "exp_avg_sq"):
            want, got = opt.state[p][moment], fresh_opt.state[q][moment]
            assert torch.equal(got, want)
            if got.dim() == 4:
                assert got.is_contiguous(memory_format=CL)


def test_nchw_state_dict_loads_into_channels_last_weights():
    """A state dict taken from an NCHW-contiguous copy fills the
    channels_last parameters in place: same values, same keys, same
    format, the same Parameter objects."""
    torch.manual_seed(2)
    src = FullNet(**SMALL)
    sd = {k: v.contiguous() for k, v in random_state_dict(src, 5).items()}
    assert any(v.dim() == 4 and not v.is_contiguous(memory_format=CL)
               for v in sd.values())
    model = FullNet(**SMALL)
    before = [id(p) for p in model.parameters()]
    model.load_state_dict(sd)
    assert [id(p) for p in model.parameters()] == before
    _assert_same_channels_last(model, sd)


def test_jax_converter_output_loads_into_channels_last_weights():
    """The port's state dict through the JAX package's torch -> flax map
    and back through `fullnet_state_dict_from_jax` loads with the same
    values and keys into a channels_last FullNet."""
    torch.manual_seed(3)
    model = FullNet(**SMALL)
    sd = {k: v.numpy() for k, v in random_state_dict(model, 4).items()
          if not k.endswith("num_batches_tracked")}
    tb = convert_fullnet_reference_checkpoint(sd, "resnet18", "resnet18")
    back = fullnet_state_dict_from_jax(tb.params, tb.batch_stats, "resnet18",
                                       "resnet18")
    model.load_state_dict(back)
    got = model.state_dict()
    assert sorted(back) == sorted(k for k in got
                                  if not k.endswith("num_batches_tracked"))
    for k, v in sd.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert _not_channels_last(model.named_parameters()) == []


def test_seeded_fullnet_draws_the_values_it_drew_in_nchw():
    """Converting the weights after the initialisers moves no value: a
    seeded FullNet's state dict hashes as it did before the format
    changed."""
    torch.manual_seed(0)
    model = FullNet(**SMALL)
    assert _not_channels_last(model.named_parameters()) == []
    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().contiguous().numpy().tobytes())
    assert h.hexdigest() == SEEDED_DIGEST
