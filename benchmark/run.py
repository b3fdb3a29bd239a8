"""Run one cell of the benchmark of `horopose_tpu_torch` once.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for. Everything is found by name from `BENCHMARK.json`:
the cell's configuration (`benchmark/configs/<config>.json`), its traffic
mix (`benchmark/traffic/<traffic>.json`, whose `mode` names the loop in
`benchmark/modes/`), every metric (`benchmark/metrics/<metric>.py`, a
`read(run)` that returns a number or None) and the cell's limits
(`benchmark/limits/<workload>.json`). With `--trace 0` the last line of
standard output carries the cell's end-to-end metrics, with `--trace 1`
its per-layer metrics, as one JSON object; the numbers compared with the
reference, each with its limit, end both that line (`checks`) and
standard error. Exit codes: 0 a result was printed (correct or not),
2 no card or too few, 4 a module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Mapping, Optional  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the program's caches and builds stay inside the checkout, at fixed paths
CACHE = os.path.join(ROOT, ".bench_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "horopose_tpu")


def set_cache_dirs() -> None:
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> List[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (`horopose_tpu_torch` is not `horopose_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def load_benchmark(path: Optional[str] = None) -> dict:
    with open(path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(root: str, kind: str, name: str) -> dict:
    with open(os.path.join(root, kind, f"{name}.json")) as f:
        return json.load(f)


def load_metric(root: str, name: str):
    """`<root>/metrics/<name>.py`, loaded by its path (names hold dots)."""
    path = os.path.join(root, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metrics_of(bench: Mapping, workload: str, trace: bool) -> List[dict]:
    """The metrics a run of `workload` reports: per-layer with a trace,
    end-to-end without, each where it lists the cell or lists none."""
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if workload in m.get("workloads", [workload])]


def power_limit_w() -> Optional[float]:
    """The card's power limit (nvidia-smi), which the peaks assume."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def device_info(device, n: int) -> dict:
    import torch
    if torch.device(device).type == "cuda":
        return dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                    count=n, power_limit_w=power_limit_w())
    return dict(platform="cpu", kind="cpu", count=n)


def run_cell(bench: Mapping, workload: str, seed: int, seconds: float,
             trace: bool, device="cuda", root: str = HERE,
             t_start: float = T_START, **ctx_extra) -> Dict:
    """One run of a cell; returns the result line's object. `ctx_extra`
    reaches the cell's mode (tests pass `program_dtype`)."""
    from benchmark import compare
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    traffic = load_json(root, "traffic", cell["traffic"])
    ctx = dict(config=load_json(root, "configs", cell["config"]),
               traffic=traffic, seed=int(seed), seconds=float(seconds),
               trace=bool(trace), device=device, t_start=t_start,
               workload=workload, **ctx_extra)
    mode = importlib.import_module(f"benchmark.modes.{traffic['mode']}")
    out = mode.run(ctx)
    window = out["window"]
    run = dict(ctx, **window, setup_s=ctx["setup_s"])
    metrics = {}
    for m in metrics_of(bench, workload, trace):
        value = load_metric(root, m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = dict(value=float(value), unit=m["unit"])
    correct, checks = compare.verdict(out["numbers"],
                                      compare.load_limits(root, workload))
    dev = device_info(device, int(cell["chips"]))
    dev["memory_peak_bytes"] = int(window["memory_peak_bytes"])
    result = dict(correct=bool(correct), attempted=int(window["attempted"]),
                  failed=int(window["failed"]), metrics=metrics, device=dev)
    t = window.get("trace")
    if trace and t is not None:
        dev["busy_s"], dev["window_s"] = t.busy_s, t.window_s
        outer = "call" if traffic["mode"] == "serve" else "step"
        result["breakdown"] = dict(device_ops=t.top_ops(),
                                   idle_gaps=t.top_gaps(outer))
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    set_cache_dirs()
    bench = load_benchmark()
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"loaded modules of JAX or the JAX package: {found}",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
