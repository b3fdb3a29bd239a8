"""Training cells: the program's stage-2 step over a pool of batches
already on the card.

Set-up makes the batches and the weights from the seed, builds one model,
its optimizer and the step (`core/engine.py::build_full_train_step` with
`make_optimizer`), and drives that same step through its first
`checked_steps` steps on the first pool entries (rows that all differ),
keeping the loss of each, every leaf's norm of the first gradient (from
Adam's first moment) and of the parameters' change after the checked
steps; then `warmup_steps` more. The window runs the step back to back
over the pool in an order drawn from the seed until `seconds` have
passed, and ends when the card has finished the last step. A traced run
follows with `trace_steps` steps under the profiler. Once the program is
freed the plain reference follows the checked steps from the same
weights, batches and dropout draws.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import torch

from benchmark import compare, generate, trace
from benchmark.reference.fullnet import reference_model
from benchmark.reference import train as ref_train
from benchmark.reference.robot import RobotFK
from benchmark.weights import make_state_dict


def steps_per_epoch(config: dict) -> int:
    return max(int(config["epoch_size"]) // int(config["batch_size"]), 1)


def weights(config: dict, batches: List[dict], seed: int, device):
    """The cell's weights: residual branches damped, the depth head at the
    pool's mean root depth for its k priors."""
    robot = RobotFK(config["urdf_robot_name"], device=device)
    gamma = []
    for b in batches:
        gt = ref_train.ground_truth(config, robot, b)
        gamma.append(gt["root_trans"][:, 2] * 1000.0 / gt["k"])
    return make_state_dict(reference_model(config, robot),
                           generate.stream_seed(seed, "weights"), device,
                           float(torch.cat(gamma).mean()),
                           scales={"decpose.weight": 1e-3,
                                   "decrot.weight": 1e-3},
                           damp_residual=True)


def build_program(config: dict, state_dict, device, dtype=torch.float32):
    """(model, optimizer, step) of the program."""
    from horopose_tpu_torch.core import engine
    from horopose_tpu_torch.pipelines import common
    cfg = common.FullNetConfig.from_cfg(config)
    model = common.build_fullnet(cfg, dtype=dtype)
    model.load_state_dict(state_dict)
    model.to(device)
    opt, sched = engine.make_optimizer(cfg, model.parameters(),
                                       steps_per_epoch(config))
    step = engine.build_full_train_step(
        cfg, model, common.make_robot(cfg, device=device), opt, sched)
    return model, opt, step


def run(ctx: dict) -> dict:
    config, traffic, seed = ctx["config"], ctx["traffic"], ctx["seed"]
    device = ctx["device"]
    batches = generate.train_batches(traffic, config["urdf_robot_name"],
                                     int(config["image_size"]), seed, device)
    n_checked = int(traffic["checked_steps"])
    if len(batches) < n_checked:
        raise ValueError("the pool needs a batch for every checked step")
    model, opt, step = build_program(
        config, weights(config, batches, seed, device), device,
        ctx.get("program_dtype", torch.float32))
    gen = generate.torch_generator(seed, "dropout", device)
    program = first_steps(model, opt, step, batches, gen, n_checked)
    for i in range(int(traffic["warmup_steps"])):
        step(batches[(n_checked + i) % len(batches)], gen)
    order = generate.order(traffic, seed, 1 << 16)
    compare.sync(device)
    t0 = time.perf_counter()
    ctx["setup_s"] = t0 - ctx["t_start"]
    logs = []
    while time.perf_counter() - t0 < ctx["seconds"]:
        logs.append(step(batches[order[len(logs)]], gen)["loss"])
    compare.sync(device)
    window = dict(window_s=time.perf_counter() - t0, steps=len(logs),
                  images=len(logs) * int(traffic["batch"]),
                  attempted=len(logs))
    window["failed"] = int(sum(not math.isfinite(float(x)) for x in logs))
    window["memory_peak_bytes"] = compare.memory_peak(device)
    if ctx["trace"]:
        window.update(_traced(model, opt, step, batches,
                              order[len(logs):], gen, traffic, device))
    del model, opt, step
    gc.collect()
    compare.empty_cache(device)
    reference = follow(config, batches, seed, n_checked, device)
    return dict(window=window, detail=dict(program=program,
                                           reference=reference),
                numbers=compare.train_numbers(program, reference))


def first_steps(model, opt, step, batches: List[dict], gen, n: int) -> Dict:
    """The program's first `n` steps on the first `n` batches: each step's
    loss and named losses, every leaf's norm of the first gradient as Adam
    got it (m / (1 - beta1) after one step) and of the parameters' change
    after the `n` steps."""
    params = dict(model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    beta1 = opt.param_groups[0]["betas"][0]
    logs, grad = [], {}
    for i in range(n):
        logs.append(step(batches[i], gen))
        if i == 0:
            grad = compare.leaf_norms({
                k: opt.state[p]["exp_avg"] / (1.0 - beta1) if p in opt.state
                else torch.zeros_like(p) for k, p in params.items()})
    change = compare.leaf_norms({k: params[k].detach() - start[k]
                                 for k in params})
    return dict(losses=[float(lg["loss"]) for lg in logs], grad=grad,
                change=change,
                parts=[{k: float(v) for k, v in lg.items()} for lg in logs])


def _traced(model, opt, step, batches, order, gen, traffic, device) -> Dict:
    """The profiled stretch of whole steps, the model's forward and the
    optimizer's update in spans."""
    n = int(traffic["trace_steps"])
    stages = dict(forward=(model, "forward"), optimizer=(opt, "step"))
    saved = {name: owner.__dict__.get(attr)
             for name, (owner, attr) in stages.items()}
    spans = trace.Spans()

    def in_span(name, fn):
        def inner(*args, **kwargs):
            with spans.span(name):
                return fn(*args, **kwargs)
        return inner

    def stretch():
        for p in order[:n]:
            with spans.span("step"):
                step(batches[p], gen)

    for name, (owner, attr) in stages.items():
        setattr(owner, attr, in_span(name, getattr(owner, attr)))
    try:
        t = trace.capture(stretch, device, spans)
    finally:
        for name, (owner, attr) in stages.items():
            if saved[name] is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, saved[name])
    return dict(trace=t, trace_steps=n)


def follow(config: dict, batches: List[dict], seed: int, n_steps: int,
           device) -> Dict:
    """The plain reference through the checked steps, float32, TF32 off."""
    robot = RobotFK(config["urdf_robot_name"], device=device)
    model = reference_model(config, robot).to_empty(device=device)
    sd = weights(config, batches, seed, device)
    model.load_state_dict(sd)
    ref = ref_train.TrainReference(config, model, robot,
                                   steps_per_epoch(config))
    gen = generate.torch_generator(seed, "dropout", device)
    losses, grad, parts = [], {}, []
    with compare.tf32_off():
        for i in range(n_steps):
            losses.append(ref.step(batches[i], gen))
            parts.append(ref.parts)
            if i == 0:
                grad = compare.leaf_norms(ref.grads)
    change = compare.leaf_norms({k: p.detach() - sd[k]
                                 for k, p in ref.params.items()})
    return dict(losses=losses, grad=grad, change=change, parts=parts)
