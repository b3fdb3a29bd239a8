"""Resuming a JAX run in the port, on the CPU: optax's Adam state (the
moments, the step count, the schedule's position) carried into the port's
`torch.optim.Adam` and LambdaLR by `core/checkpoint.py::restore_state`.

The optax chain is the JAX package's `make_optimizer` over a FullNet
(resnet18 + resnet18, 64 px, depth_dim 8) whose variables are numpy values
on the tree `jax.eval_shape` gives: no model forward and no model compile.
The state is seeded (count 2, nu > 0) and so are the gradients; one
`tx.update` + `apply_updates` in JAX (jitted: one small elementwise
program, ~3 s to compile, where the op-by-op update takes ~18 s) and one
`optimizer.step()` in the port after the restore must give the same
parameters and the same next LR, for each shape the chain takes."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from horopose_tpu.config import make_default_cfg as jax_default_cfg
from horopose_tpu.core import engine as JE
from horopose_tpu.core.checkpoint import \
    save_checkpoint_file as jax_save_checkpoint
from horopose_tpu.pipelines.common import build_fullnet as jax_build_fullnet
from horopose_tpu_torch.core.checkpoint import (TrainState,
                                                load_checkpoint_file,
                                                restore_state)
from horopose_tpu_torch.core.engine import (clip_by_global_norm_,
                                            make_optimizer)
from horopose_tpu_torch.pipelines.common import FullNetConfig, build_fullnet
from horopose_tpu_torch.tools.jax_weights import (adam_state_dicts_from_jax,
                                                  fullnet_state_dict_from_jax,
                                                  params_like_from_jax)

from test_torch_port_models import random_jax_variables

S = 64
COUNT = 2
STEPS_PER_EPOCH = 1         # the schedule moves every step
PARAM_REL = 1e-5
# (clip_gradient, weight_decay): the chain's three shapes
CHAINS = {"clip+decay+adam": (10.0, 1e-3), "clip+adam": (10.0, 0.0),
          "adam": (0.0, 0.0)}
SCHEDULE = dict(lr=1e-3, use_schedule=True, n_epochs_warmup=5,
                schedule_type="exponential", start_decay=45.0,
                end_decay=100.0, exponent=0.95)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def variables():
    jcfg = jax_default_cfg()
    jcfg.update(backbone_name="resnet18", rootnet_backbone_name="resnet18",
                image_size=float(S))
    model = jax_build_fullnet(jcfg).clone(depth_dim=8)
    x = np.zeros((1, S, S, 3), np.float32)
    return random_jax_variables(
        model, (x, x, np.ones((1,), np.float32),
                np.eye(3, dtype=np.float32)[None]), seed=21)


def _cfgs(chain):
    clip, decay = CHAINS[chain]
    jcfg = jax_default_cfg()
    jcfg.update(clip_gradient=clip, weight_decay=decay, **SCHEDULE)
    cfg = FullNetConfig(backbone_name="resnet18",
                        rootnet_backbone_name="resnet18", image_size=S,
                        depth_dim=8, clip_gradient=clip, weight_decay=decay,
                        **SCHEDULE)
    return jcfg, cfg


def _seeded_like(tree, seed, positive=False):
    rng = np.random.RandomState(seed)

    def leaf(x):
        v = rng.randn(*np.shape(x)).astype(np.float32)
        return 1e-4 * (v * v + 0.1) if positive else 1e-2 * v

    return jax.tree.map(leaf, tree)


def _seeded_opt_state(tx, params, seed):
    """`tx.init(params)` with adam's count and the schedule's at COUNT and
    seeded moments (nu > 0). Adam is the chain's last part, itself
    (ScaleByAdamState, ScaleByScheduleState)."""
    state = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                         jax.eval_shape(tx.init, params))
    adam, sched = state[-1]
    count = jnp.asarray(COUNT, jnp.int32)
    adam = adam._replace(count=count, mu=_seeded_like(params, seed),
                         nu=_seeded_like(params, seed + 1, positive=True))
    return state[:-1] + ((adam, sched._replace(count=count)),)


def _port_state(cfg):
    model = build_fullnet(cfg)
    optimizer, scheduler = make_optimizer(cfg, model.parameters(),
                                          STEPS_PER_EPOCH)
    return TrainState(model, optimizer, scheduler)


def _payload(variables, opt_state):
    """What the JAX keeper writes, as the port reads it back."""
    return dict(epoch=np.int64(1), metric=np.float64(0.5),
                params=variables["params"],
                batch_stats=variables["batch_stats"],
                opt_state=serialization.to_state_dict(
                    jax.tree.map(np.asarray, opt_state)),
                step=np.asarray(COUNT, np.int32))


def _port_step(state, grads, cfg):
    """The port's train step after the backward: `.grad` from the JAX
    gradients, the clip, Adam, the scheduler."""
    g = params_like_from_jax(state.model, grads)
    params = list(state.model.parameters())
    for name, p in state.model.named_parameters():
        p.grad = g[name].clone()
    if cfg.clip_gradient:
        clip_by_global_norm_(params, float(cfg.clip_gradient))
    state.optimizer.step()
    state.scheduler.step()


@pytest.mark.parametrize("chain", list(CHAINS))
def test_one_more_step_matches_optax(chain, variables):
    jcfg, cfg = _cfgs(chain)
    params = variables["params"]
    tx = JE.make_optimizer(jcfg, STEPS_PER_EPOCH)
    opt_state = _seeded_opt_state(tx, params, seed=5)
    grads = _seeded_like(params, 7)
    grads = jax.tree.map(lambda g: 100.0 * g, grads)   # norm above the clip
    step = jax.jit(lambda g, s, p: optax.apply_updates(
        p, tx.update(g, s, p)[0]))
    new_params = jax.tree.map(np.asarray, step(grads, opt_state, params))
    want = fullnet_state_dict_from_jax(new_params, variables["batch_stats"],
                                       "resnet18", "resnet18")

    state = _port_state(cfg)
    restore_state(state, _payload(variables, opt_state))
    lr_now = float(JE.schedule_ratio(jcfg, jnp.asarray(COUNT))) * jcfg.lr
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(
        lr_now, rel=1e-7)
    assert all(int(s["step"]) == COUNT
               for s in state.optimizer.state.values())
    _port_step(state, grads, cfg)
    got = dict(state.model.named_parameters())
    assert set(got) <= set(want)
    for name, p in got.items():
        w = want[name]
        err = float((p.detach() - w).abs().max() / w.abs().max())
        assert err <= PARAM_REL, (name, err)
    # the next update's LR: optax's lr(count + 1)
    lr_next = float(JE.schedule_ratio(jcfg, jnp.asarray(COUNT + 1))) * jcfg.lr
    assert lr_next != lr_now
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(
        lr_next, rel=1e-7)
    assert state.scheduler.last_epoch == COUNT + 1


def test_resume_from_a_jax_checkpoint_file(variables, tmp_path):
    """The JAX package's `save_checkpoint_file`, read back by the port's
    `load_checkpoint_file` and `restore_state`: weights, moments, step
    and the schedule's position."""
    jcfg, cfg = _cfgs("clip+decay+adam")
    tx = JE.make_optimizer(jcfg, STEPS_PER_EPOCH)
    jstate = JE.create_train_state(jax.tree.map(jnp.asarray, variables), tx)
    jstate = jstate.replace(
        opt_state=_seeded_opt_state(tx, variables["params"], seed=8),
        step=jnp.asarray(COUNT, jnp.int32))
    path = str(tmp_path / "jax.pk")
    jax_save_checkpoint(path, epoch=1, metric=0.5, state=jstate)
    state = _port_state(cfg)
    restore_state(state, load_checkpoint_file(path))
    mu = params_like_from_jax(state.model,
                              jax.tree.map(np.asarray,
                                           jstate.opt_state[-1][0].mu))
    names = [n for n, _ in state.model.named_parameters()]
    opt = state.optimizer.state_dict()["state"]
    assert len(opt) == len(names)
    for i, name in enumerate(names):
        assert int(opt[i]["step"]) == COUNT
        assert torch.equal(opt[i]["exp_avg"], mu[name]), name
    want = fullnet_state_dict_from_jax(variables["params"],
                                       variables["batch_stats"], "resnet18",
                                       "resnet18")
    assert torch.equal(state.model.state_dict()["final_layer.weight"],
                       want["final_layer.weight"])
    assert state.scheduler.last_epoch == COUNT


def test_moment_map_refuses_what_it_cannot_place(variables):
    """A moment without a parameter in the optimizer, and a parameter
    without a moment, raise."""
    jcfg, cfg = _cfgs("adam")
    tx = JE.make_optimizer(jcfg, STEPS_PER_EPOCH)
    opt_state = serialization.to_state_dict(jax.tree.map(
        np.asarray, _seeded_opt_state(tx, variables["params"], seed=3)))
    state = _port_state(cfg)
    first = next(state.model.parameters())
    partial = torch.optim.Adam([p for p in state.model.parameters()
                                if p is not first])
    with pytest.raises(ValueError, match="have no parameter"):
        adam_state_dicts_from_jax(state.model, partial, None, opt_state)
    adam = opt_state["0"]["0"]
    mu = dict(adam["mu"])
    mu.pop("final_layer")
    cut = {"0": {"0": dict(adam, mu=mu, nu=mu), "1": opt_state["0"]["1"]}}
    with pytest.raises(ValueError, match="final_layer"):
        adam_state_dicts_from_jax(state.model, state.optimizer, None, cut)
