"""Serving cells: a closed loop of one client through `Predictor.__call__`.

Set-up makes the pool of requests and the weights from the seed, builds
the program's Predictor, and serves every request of the pool once (the
warm-up: the kernels' build, cuDNN's first calls at these shapes). The
window then sends requests back to back, in an order drawn from the seed,
until `seconds` have passed, and ends with the call in flight: it lasts
from its first call's start to its last call's end. A traced run follows
with `trace_calls` calls under the profiler and `prep_calls` calls with
the request prep timed alone. Every answer, the warm-up's included, is
kept and judged against the plain reference once the program is freed.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import compare, generate, trace
from benchmark.reference import serve as ref_serve
from benchmark.reference.fullnet import reference_model
from benchmark.reference.robot import RobotFK
from benchmark.weights import make_state_dict


def _k_values(req: dict) -> np.ndarray:
    H, W = req["frames"].shape[1:3]
    side = np.array([max(b[2] - b[0], b[3] - b[1]) for b in
                     (ref_serve.strict_bbox(bb, W, H) for bb in req["bboxes"])])
    K = req["K"]
    return np.sqrt(np.abs(K[:, 0, 0] * K[:, 1, 1]) * 1e6) / side


def weights(config: dict, traffic: dict, requests: List[dict], seed: int,
            device):
    """The cell's weights: the depth head at the traffic's scene depth
    for the pool's median k prior."""
    robot = RobotFK(config["urdf_robot_name"])
    k = np.concatenate([_k_values(r) for r in requests])
    gamma = float(traffic["scene_depth_m"]) * 1000.0 / float(np.median(k))
    return make_state_dict(reference_model(config, robot),
                           generate.stream_seed(seed, "weights"), device,
                           gamma, scales={"decrot.weight": 0.05})


def build_program(config: dict, state_dict, device, dtype=torch.float32):
    """The program's Predictor of the configuration, with these weights."""
    from horopose_tpu_torch.pipelines.common import FullNetConfig
    from horopose_tpu_torch import predictor
    return predictor.Predictor(FullNetConfig.from_cfg(config), state_dict,
                               device=device, dtype=dtype)


def run(ctx: dict) -> dict:
    config, traffic, seed = ctx["config"], ctx["traffic"], ctx["seed"]
    device = ctx["device"]
    requests = generate.serve_requests(traffic, seed, device)
    pred = build_program(config, weights(config, traffic, requests, seed,
                                         device), device,
                         ctx.get("program_dtype", torch.float32))
    answers: List[tuple] = []          # (pool index, outputs)
    failed = 0

    def call(p: int) -> None:
        nonlocal failed
        req = requests[p]
        try:
            out = pred(req["frames"], req["K"], req["bboxes"])
        except RuntimeError as e:          # an answer that never comes
            print(f"call failed: {e}", flush=True)
            failed += 1
            out = None
        answers.append((p, out))

    for p in range(len(requests)):
        call(p)
    compare.sync(device)
    order = generate.order(traffic, seed, 1 << 16)
    t0 = time.perf_counter()
    ctx["setup_s"] = t0 - ctx["t_start"]
    calls: List[tuple] = []
    i = 0
    while True:
        c0 = time.perf_counter()
        call(order[i])
        c1 = time.perf_counter()
        calls.append((c0, c1, requests[order[i]]["frames"].shape[0]))
        i += 1
        if c1 - t0 >= ctx["seconds"]:
            break
    window = dict(window_s=calls[-1][1] - t0, calls=calls,
                  frames=sum(c[2] for c in calls), attempted=len(calls))
    window["memory_peak_bytes"] = compare.memory_peak(device)
    if ctx["trace"]:
        window.update(_traced(pred, call, order[i:], traffic, device))
    del pred
    gc.collect()
    compare.empty_cache(device)
    numbers = judge(config, traffic, requests, answers, seed, device)
    window["failed"] = failed
    return dict(window=window, numbers=numbers)


def _traced(pred, call, order, traffic: dict, device) -> Dict:
    """The profiled stretch (whole calls, the program's two stages in
    spans), then the request prep timed alone, each `preprocess` ended by
    a synchronise."""
    n, m = int(traffic["trace_calls"]), int(traffic["prep_calls"])
    stages = {name: getattr(pred, name) for name in ("preprocess", "forward")}
    spans = trace.Spans()

    def in_span(name, fn):
        def inner(*args, **kwargs):
            with spans.span(name):
                return fn(*args, **kwargs)
        return inner

    def stretch():
        for p in order[:n]:
            with spans.span("call"):
                call(p)

    for name, fn in stages.items():
        setattr(pred, name, in_span(name, fn))
    t = trace.capture(stretch, device, spans)
    del pred.forward
    prep_ms = []

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = stages["preprocess"](*args, **kwargs)
        compare.sync(device)
        prep_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    pred.preprocess = timed
    for p in order[n:n + m]:
        call(p)
    del pred.preprocess
    return dict(trace=t, trace_calls=n, prep_ms=prep_ms)


def reference_outputs(config: dict, traffic: dict, requests: List[dict],
                      seed: int, device, used) -> Dict[int, dict]:
    """The plain reference's outputs for every pool entry in `used`, in
    float32 with TF32 off."""
    robot = RobotFK(config["urdf_robot_name"], device=device)
    model = reference_model(config, robot).to_empty(device=device)
    model.load_state_dict(weights(config, traffic, requests, seed, device))
    with compare.tf32_off():
        return {p: ref_serve.serve(model, robot, requests[p]["frames"],
                                   requests[p]["K"], requests[p]["bboxes"])
                for p in sorted(used)}


def judge(config, traffic, requests, answers, seed, device) -> Dict[str,
                                                                    float]:
    ref = reference_outputs(config, traffic, requests, seed, device,
                            {p for p, _ in answers})
    return compare.serve_numbers(answers, ref)
