"""The harness on the CPU: it takes new cells, traffic and metrics as data,
prints one JSON result line with its fixed keys, and comes out not correct
when the timed path is broken underneath (the look for a card skipped,
small cells)."""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from benchmark import run as bench_run
from benchmark.modes import serve as serve_mode
from benchmark.modes import train as train_mode
from benchmark.tests.helpers import TINY_SERVE, TINY_TRAIN, tiny_root

SEED = 2 ** 31 + 977
LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device",
             "breakdown", "checks"}


def _digest(root: str) -> dict:
    out = {}
    for base, _, files in os.walk(root):
        if os.path.basename(base) in ("tests", "__pycache__"):
            continue
        for name in files:
            if name.endswith((".py", ".json", ".urdf")):
                path = os.path.join(base, name)
                with open(path, "rb") as f:
                    out[path] = hashlib.sha256(f.read()).hexdigest()
    return out


def _run(bench, root, workload, trace=False, seconds=0.5):
    return bench_run.run_cell(bench, workload, SEED, seconds, trace,
                              device="cpu", root=root,
                              t_start=time.perf_counter())


def test_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    before = _digest(bench_run.HERE)
    root, bench = tiny_root(tmp_path)
    with open(os.path.join(root, "metrics", "calls_seen.tiny.py"), "w") as f:
        f.write("def read(run):\n    return len(run.get('calls', [])) "
                "or None\n")
    bench["end_to_end"].append(dict(
        name="calls_seen.tiny", unit="calls", better="higher", bound=0.25,
        source="host_clock", workloads=[TINY_SERVE]))
    result = _run(bench, root, TINY_SERVE)
    assert result["correct"], result["checks"]
    assert result["metrics"]["calls_seen.tiny"]["value"] >= 1
    assert {"serve_img_per_s", "setup_s"} <= set(result["metrics"])
    assert _digest(bench_run.HERE) == before


@pytest.mark.parametrize("workload", [TINY_SERVE, TINY_TRAIN])
def test_result_line_has_only_its_keys(tmp_path, workload):
    root, bench = tiny_root(tmp_path)
    for trace in (False, True):
        result = _run(bench, root, workload, trace=trace)
        assert result["correct"], result["checks"]
        assert set(result) <= LINE_KEYS
        assert list(result)[-1] == "checks"
        assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
            set(result["device"])
        wanted = {m["name"] for m in bench_run.metrics_of(bench, workload,
                                                          trace)}
        assert set(result["metrics"]) <= wanted
        for m in result["metrics"].values():
            assert set(m) == {"value", "unit"}
        if trace:
            assert "breakdown" in result and "busy_s" in result["device"]
        json.dumps(result)


def _planted_serve(fault):
    build = serve_mode.build_program

    def planted(*args, **kwargs):
        pred = build(*args, **kwargs)

        def call(frames, K, bboxes=None):
            if fault == "half_batch":
                h = max(frames.shape[0] // 2, 1)
                out = pred(frames[:h], K[:h], bboxes[:h])
                return {k: np.concatenate([v] * (frames.shape[0] // h))
                        [:frames.shape[0]] for k, v in out.items()}
            out = pred(frames, K, bboxes)
            out["joints"] = out["joints"].copy()
            out["joints"][0, 0] += 0.1          # one angle 6 degrees off
            return out
        return call
    return planted


def _planted_train(fault):
    build = train_mode.build_program

    def planted(*args, **kwargs):
        model, opt, step = build(*args, **kwargs)
        if fault == "state_unchanged":
            def broken(batch, gen):
                logs = step(batch, gen)
                return logs
            opt.step = lambda *a, **k: None
            return model, opt, broken
        if fault == "half_batch":
            def half(tree):
                return {k: half(v) if isinstance(v, dict)
                        else v[:v.shape[0] // 2] for k, v in tree.items()}
            return model, opt, lambda batch, gen: step(half(batch), gen)

        def altered(batch, gen):
            logs = step(batch, gen)
            logs["loss"] = logs["loss"] * 1.01
            return logs
        return model, opt, altered
    return planted


@pytest.mark.parametrize("fault", ["answer_altered", "half_batch"])
def test_serving_fault_is_not_correct(tmp_path, monkeypatch, fault):
    root, bench = tiny_root(tmp_path)
    monkeypatch.setattr(serve_mode, "build_program", _planted_serve(fault))
    result = _run(bench, root, TINY_SERVE)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "loss_altered"])
def test_training_fault_is_not_correct(tmp_path, monkeypatch, fault):
    root, bench = tiny_root(tmp_path)
    monkeypatch.setattr(train_mode, "build_program", _planted_train(fault))
    result = _run(bench, root, TINY_TRAIN, seconds=0.0)
    assert result["correct"] is False, result["checks"]


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "horopose_tpu_torch_probe", object())
    assert "horopose_tpu_torch_probe" not in bench_run.forbidden_modules()
    for name in ("jax.numpy", "horopose_tpu.models", "flax", "optax"):
        monkeypatch.setitem(sys.modules, name, object())
        assert name.split(".")[0] in bench_run.forbidden_modules()


def _cli(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "panda_full.serve_b128", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=env)


def test_without_a_card_it_exits_nonzero_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = _cli(os.path.dirname(bench_run.HERE))
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_without_the_program_it_exits_nonzero(tmp_path):
    import shutil
    shutil.copytree(bench_run.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(bench_run.ROOT, "BENCHMARK.json"), tmp_path)
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    proc = _cli(str(tmp_path), env)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
