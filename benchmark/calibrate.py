"""The readings that a cell's limits are set from (run on the card).

    python3 -m benchmark.calibrate --workload <name> --seeds 1 2 ... \\
        [--control-seeds 1 2 3] [--faults half_batch] [--out readings.jsonl]

For each seed it runs the cell's loop with a window of `--seconds` (one
call or step by default) and prints the numbers the comparison reads: the
program as the configuration states it (the lower readings), the control (the program's
own bfloat16 path, the nearest precision below the float32 the cells
state), and for a training cell the planted fault of half the batch left
out (the mean taken over the rest). One JSON line a run; the last line
sums them up: the largest program reading and the smallest control and
fault reading of every number.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import Dict, List

import torch

from benchmark import run as bench_run
from benchmark.modes import serve as serve_mode
from benchmark.modes import train as train_mode


def half_batch_step(build):
    """A training build whose step sees the first half of every batch's
    rows: half the batch left out, the mean taken over the rest."""
    def planted(*args, **kwargs):
        model, opt, step = build(*args, **kwargs)

        def half(tree):
            return {k: half(v) if isinstance(v, dict) else v[:v.shape[0] // 2]
                    for k, v in tree.items()}
        return model, opt, lambda batch, gen: step(half(batch), gen)
    return planted


def one(bench, workload: str, seed: int, kind: str, device,
        seconds: float = 0.0) -> Dict:
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    traffic = bench_run.load_json(bench_run.HERE, "traffic", cell["traffic"])
    ctx = dict(config=bench_run.load_json(bench_run.HERE, "configs",
                                          cell["config"]),
               traffic=traffic, seed=seed, seconds=seconds, trace=False,
               device=device, t_start=time.perf_counter(),
               workload=workload)
    mode = serve_mode if traffic["mode"] == "serve" else train_mode
    saved = mode.build_program
    if kind == "control":
        ctx["program_dtype"] = torch.bfloat16
    elif kind == "half_batch":
        mode.build_program = half_batch_step(saved)
    try:
        out = mode.run(ctx)
    finally:
        mode.build_program = saved
    return dict(workload=workload, seed=seed, kind=kind,
                numbers=out["numbers"], setup_s=ctx["setup_s"],
                memory_peak_bytes=out["window"]["memory_peak_bytes"],
                detail=out.get("detail"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=0.0,
                   help="a window as long as a run's, so that a serving "
                   "cell compares as many answers as a run does")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    bench_run.set_cache_dirs()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    bench = bench_run.load_benchmark()
    rows: List[Dict] = []
    plan = [(s, "program") for s in args.seeds] + \
        [(s, "control") for s in args.control_seeds] + \
        [(s, f) for f in args.faults for s in args.control_seeds]
    for seed, kind in plan:
        row = one(bench, args.workload, seed, kind, "cuda", args.seconds)
        rows.append(row)
        line = json.dumps(row)
        print(json.dumps({k: v for k, v in row.items() if k != "detail"}),
              flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    summary = {}
    for kind in {r["kind"] for r in rows}:
        pick = max if kind == "program" else min
        mine = [r["numbers"] for r in rows if r["kind"] == kind]
        summary[kind] = {k: pick(n[k] for n in mine) for k in mine[0]}
    low, ctrl = summary.get("program", {}), summary.get("control", {})
    summary["ratio"] = {k: (ctrl[k] / low[k] if low.get(k) else math.inf)
                        for k in ctrl}
    print(json.dumps(dict(summary=summary)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
