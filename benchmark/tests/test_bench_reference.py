"""The plain reference on the CPU at full width: it agrees with the
program's serving path and train step, the program's bfloat16 path fails
the comparison that float32 passes, and it imports nothing of the
program, of JAX or of the JAX package."""

from __future__ import annotations

import ast
import glob
import os
import subprocess
import sys

import pytest
import torch

from benchmark import compare, generate
from benchmark import run as bench_run
from benchmark.modes import serve as serve_mode
from benchmark.modes import train as train_mode

SEED = 2 ** 31 + 4099
CONFIGS = ("panda_full", "baxter_full")
# float32 against float32 on one CPU: the two sum in another order
SERVE_TOL = 1e-5
LOSS_TOL = 1e-5
# the worst of ~1,000 leaves, where BatchNorm's statistics over two rows
# magnify the sums' rounding (3.4e-3 read here)
GRAD_TOL = 1e-2


def _serve_traffic():
    t = bench_run.load_json(bench_run.HERE, "traffic", "serve_b128")
    t.update(batch=2, pool=1)
    return t


def _train_traffic():
    t = bench_run.load_json(bench_run.HERE, "traffic", "train_b64")
    t.update(batch=2, pool=3)
    return t


def _serve_numbers(config, dtype):
    c = bench_run.load_json(bench_run.HERE, "configs", config)
    t = _serve_traffic()
    reqs = generate.serve_requests(t, SEED, "cpu")
    pred = serve_mode.build_program(
        c, serve_mode.weights(c, t, reqs, SEED, "cpu"), "cpu", dtype)
    r = reqs[0]
    answers = [(0, pred(r["frames"], r["K"], r["bboxes"]))]
    return serve_mode.judge(c, t, reqs, answers, SEED, "cpu")


def _train_numbers(config, dtype, steps=1):
    c = bench_run.load_json(bench_run.HERE, "configs", config)
    t = _train_traffic()
    batches = generate.train_batches(t, c["urdf_robot_name"],
                                     int(c["image_size"]), SEED, "cpu")
    model, opt, step = train_mode.build_program(
        c, train_mode.weights(c, batches, SEED, "cpu"), "cpu", dtype)
    gen = generate.torch_generator(SEED, "dropout", "cpu")
    program = train_mode.first_steps(model, opt, step, batches, gen, steps)
    reference = train_mode.follow(c, batches, SEED, steps, "cpu")
    return compare.train_numbers(program, reference)


@pytest.mark.parametrize("config", CONFIGS)
def test_serving_reference_matches_the_program(config):
    numbers = _serve_numbers(config, torch.float32)
    for key in compare.OUTPUT_KEYS:
        assert numbers[key] <= SERVE_TOL, (key, numbers[key])


@pytest.mark.parametrize("config", CONFIGS)
def test_train_reference_matches_one_program_step(config):
    numbers = _train_numbers(config, torch.float32)
    assert numbers["loss"] <= LOSS_TOL, numbers
    assert numbers["grad"] <= GRAD_TOL, numbers


@pytest.mark.parametrize("workload", ["panda_full.serve_b128",
                                      "baxter_full.train_b64"])
def test_bfloat16_fails_what_float32_passes(workload):
    config = workload.split(".")[0]
    limits = compare.load_limits(bench_run.HERE, workload)
    numbers = _serve_numbers if "serve" in workload else _train_numbers
    assert compare.verdict(numbers(config, torch.float32), limits)[0]
    assert not compare.verdict(numbers(config, torch.bfloat16), limits)[0]


FORBIDDEN_ROOTS = {"horopose_tpu_torch", "horopose_tpu", "jax", "jaxlib",
                   "flax", "optax"}


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(bench_run.HERE, "reference", "*.py")):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = [a.name for a in node.names] if isinstance(
                node, ast.Import) else [node.module or ""] if isinstance(
                node, ast.ImportFrom) else []
            for name in names:
                root = name.split(".")[0]
                assert root not in FORBIDDEN_ROOTS, (path, name)
                assert root in {"benchmark", "torch", "numpy", "json", "os",
                                "math", "typing", "xml", "__future__"}, \
                    (path, name)
    code = ("import sys, benchmark.reference.serve, benchmark.reference.train;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         cwd=bench_run.ROOT).stdout
    loaded = set(ast.literal_eval(out))
    assert not loaded & FORBIDDEN_ROOTS, loaded & FORBIDDEN_ROOTS
