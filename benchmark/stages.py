"""The card's idle time in a cell's traced stretch, put down to the
program's stages.

    python3 -m benchmark.stages --workload <name> --seed <n> \\
        [--seconds <s>] [--cost <rounds>]

runs one cell as `python3 -m benchmark.run ... --trace 1` does, with the
profiled stretch inside `horopose_tpu_torch.core.profiling.record()`: the
program's spans (`serve.*`, `step.*`) join the harness's, so the
breakdown's idle gaps name the program's stages, and the stretch's idle
time (its window less the union of the card's activity, `Trace.gaps`) is
split by overlap with the host intervals in which each stage was open.
The last line of standard output is one JSON object: the run's result
line, the stage readings below (`readings`), the idle ms of each innermost
program span and outside every span (`idle_ms`, which add up to the
stretch's idle, `idle_total_ms`), the counters' gains over the stretch,
and with `--cost` what recording costs (`cost`). Exit code 2: no card.

The harness's own traced run does not record the program's spans (its
modes would open `record()` around the stretch); the readings are what
per-layer metrics would read there:
- `idle_prep_ms.serve`, `idle_forward_ms.serve`, `idle_return_ms.serve`:
  the card's idle ms overlapping `serve.prep`, `serve.forward` and
  `serve.return` (or a descendant), per traced call;
- `upload_gb_per_s.serve`: the counter `serve.upload_bytes` over the
  stretch, over the device seconds of its `Memcpy HtoD` activity, GB/s;
- `idle_forward_ms.train` (`step.prepare_gt`, `step.forward`,
  `step.losses`), `idle_backward_ms.train` (`step.backward`) and
  `idle_update_ms.train` (`step.clip`, `step.optimizer`): the same per
  traced step;
- `optimizer_ms.train`: the `step.optimizer` spans' host ms per traced
  step (Adam's and the scheduler's host time).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

SERVE_STAGES = {"idle_prep_ms.serve": ("serve.prep",),
                "idle_forward_ms.serve": ("serve.forward",),
                "idle_return_ms.serve": ("serve.return",)}
TRAIN_STAGES = {"idle_forward_ms.train": ("step.prepare_gt", "step.forward",
                                          "step.losses"),
                "idle_backward_ms.train": ("step.backward",),
                "idle_update_ms.train": ("step.clip", "step.optimizer")}
ROOTS = {"serve": "serve.call", "train": "train.step"}

Interval = Tuple[int, int]


def union(intervals) -> List[Interval]:
    """Sorted, disjoint intervals covering the same time."""
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def overlap_ns(xs: Sequence[Interval], ys: Sequence[Interval]) -> int:
    """The length of the intersection of two sorted, disjoint lists."""
    i = j = total = 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(hi - lo, 0)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def _chain(spans, i: int):
    """Span i's name and its ancestors', innermost first."""
    while i is not None and spans[i] is not None:
        yield spans[i][2]
        i = spans[i][3]


def host_intervals(spans, names) -> List[Interval]:
    """The host intervals in which a span of `names`, or one of its
    descendants, was open (spans still open when recording ended, None,
    are left out)."""
    return union(s[:2] for i, s in enumerate(spans) if s is not None
                 and any(n in names for n in _chain(spans, i)))


def idle_in(trace, spans, names) -> float:
    """Seconds of the card's idle time in the stretch (`trace.gaps()`)
    that overlap host intervals in which a span of `names`, or one of its
    descendants, was open: attributed by overlap, not by a gap's start."""
    return overlap_ns(trace.gaps(), host_intervals(spans, names)) / 1e9


def idle_by_span(trace, spans) -> Dict[str, float]:
    """The stretch's idle ms under the innermost span open on the host,
    `outside` where none is: the parts add up to the stretch's idle."""
    closed = []
    for i, s in enumerate(spans):
        if s is not None:
            closed.append((s[0], s[1], len(list(_chain(spans, i))), s[2]))
    cuts = sorted({t for s in closed for t in s[:2]})
    out: Dict[str, float] = defaultdict(float)
    for a, b in trace.gaps():
        points = [a] + [t for t in cuts if a < t < b] + [b]
        for lo, hi in zip(points, points[1:]):
            inner = max((s for s in closed if s[0] <= lo and hi <= s[1]),
                        key=lambda s: (s[2], s[0]), default=None)
            out["outside" if inner is None else inner[3]] += (hi - lo) / 1e6
    return dict(out)


def readings(trace, spans, counts, mode: str) -> Dict[str, float]:
    """The stage readings of one traced stretch (module docstring); empty
    without card activity or program spans."""
    roots = [s for s in spans if s is not None and s[3] is None
             and s[2] == ROOTS[mode]]
    if trace is None or not trace.device or not roots:
        return {}
    n = len(roots)
    stages = SERVE_STAGES if mode == "serve" else TRAIN_STAGES
    out = {name: 1e3 * idle_in(trace, spans, names) / n
           for name, names in stages.items()}
    if mode == "serve":
        htod_ns = sum(b - a for a, b, name in trace.device
                      if "Memcpy HtoD" in name)
        if htod_ns and counts.get("serve.upload_bytes"):
            out["upload_gb_per_s.serve"] = counts["serve.upload_bytes"] / \
                htod_ns
    else:
        out["optimizer_ms.train"] = sum(
            s[1] - s[0] for s in spans
            if s is not None and s[2] == "step.optimizer") / 1e6 / n
    return out


def _cell(bench, root: str, workload: str) -> Tuple[dict, dict, dict]:
    """(cell, configuration, traffic) of `workload`."""
    from benchmark import run as bench_run
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    return (cell, bench_run.load_json(root, "configs", cell["config"]),
            bench_run.load_json(root, "traffic", cell["traffic"]))


def traced_cell(workload: str, seed: int, seconds: float, device="cuda",
                bench: Optional[dict] = None,
                root: Optional[str] = None) -> dict:
    """One traced run of the cell (`benchmark.run.run_cell` over `bench`
    and the files under `root`, by default the benchmark's own), its
    profiled stretch inside `record()`; the result line and the stretch's
    stage readings."""
    from horopose_tpu_torch.core import profiling

    from benchmark import run as bench_run
    from benchmark import trace as bench_trace
    bench = bench or bench_run.load_benchmark()
    root = root or bench_run.HERE
    capture, seen = bench_trace.capture, []

    def recording(fn, dev, spans):
        with profiling.record() as rec:
            t = capture(fn, dev, spans)
        t.spans += [s[:3] for s in rec.spans if s is not None]
        seen.append((t, rec))
        return t

    mode = _cell(bench, root, workload)[2]["mode"]
    bench_trace.capture = recording
    try:
        result = bench_run.run_cell(bench, workload, seed, seconds, True,
                                    device=device, root=root,
                                    t_start=time.perf_counter())
    finally:
        bench_trace.capture = capture
    t, rec = seen[0]
    idle = idle_by_span(t, rec.spans)
    return dict(result=result, readings=readings(t, rec.spans, rec.counts,
                                                 mode),
                idle_ms=idle, idle_total_ms=1e3 * (t.window_s - t.busy_s),
                idle_sum_ms=sum(idle.values()), counts=rec.counts,
                spans=len(rec.spans))


def span_us(n: int = 100000) -> Dict[str, float]:
    """Host microseconds of one empty `with span(...)`, recording off and
    on."""
    from horopose_tpu_torch.core.profiling import record, span

    def loop():
        t0 = time.perf_counter()
        for _ in range(n):
            with span("cost"):
                pass
        return 1e6 * (time.perf_counter() - t0) / n

    off = loop()
    with record():
        on = loop()
    return dict(off=off, on=on)


def _program(workload: str, seed: int, device, bench: Optional[dict],
             root: Optional[str]):
    """(one call or step of the cell's program, ending in a synchronise;
    its count of spans), built and warmed up as the cell's set-up does."""
    from benchmark import compare, generate
    from benchmark import run as bench_run
    from benchmark.modes import serve, train
    _, config, traffic = _cell(bench or bench_run.load_benchmark(),
                               root or bench_run.HERE, workload)
    order = iter(generate.order(traffic, seed, 1 << 16))
    if traffic["mode"] == "serve":
        requests = generate.serve_requests(traffic, seed, device)
        pred = serve.build_program(config, serve.weights(
            config, traffic, requests, seed, device), device)

        def one():
            r = requests[next(order)]
            pred(r["frames"], r["K"], r["bboxes"])
        n_spans = 9
    else:
        batches = generate.train_batches(
            traffic, config["urdf_robot_name"], int(config["image_size"]),
            seed, device)
        _, _, step = train.build_program(config, train.weights(
            config, batches, seed, device), device)
        gen = generate.torch_generator(seed, "dropout", device)

        def one():
            step(batches[next(order)], gen)
            compare.sync(device)
        n_spans = 7
    for _ in range(int(traffic["pool"])):
        one()
    return one, n_spans


def recording_cost(workload: str, seed: int, rounds: int, device="cuda",
                   bench: Optional[dict] = None,
                   root: Optional[str] = None) -> dict:
    """The host cost of a span, and the cell's call or step time with and
    without `record()`, in turns (which goes first alternates)."""
    from horopose_tpu_torch.core.profiling import record
    one, n_spans = _program(workload, seed, device, bench, root)
    ms: Dict[str, List[float]] = {"off": [], "on": []}
    for r in range(rounds):
        for side in (("off", "on") if r % 2 == 0 else ("on", "off")):
            t0 = time.perf_counter()
            if side == "on":
                with record():
                    one()
            else:
                one()
            ms[side].append(1e3 * (time.perf_counter() - t0))
    med = {k: statistics.median(v) for k, v in ms.items()}
    us = span_us()
    return dict(ms=ms, median_ms=med, spans_per_call=n_spans, span_us=us,
                span_share=n_spans * (us["on"] - us["off"]) / 1e3 /
                med["off"])


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--cost", type=int, default=0,
                   help="rounds of the recording-cost comparison (0: none)")
    args = p.parse_args(argv)
    from benchmark import run as bench_run
    bench_run.set_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    out = traced_cell(args.workload, args.seed, args.seconds)
    if args.cost:
        out["cost"] = recording_cost(args.workload, args.seed + 1, args.cost)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
