"""Tracing, step timing and numerical tripwires.

Port of `horopose_tpu/core/profiling.py` in PyTorch's idiom:
  - `trace(log_dir)`: a `torch.profiler` context over the CPU and, where
    there is one, the card, writing a Chrome trace (chrome://tracing,
    Perfetto) into `log_dir`;
  - `enable_debug_nans`: autograd anomaly detection, which raises where a
    backward produces NaN (the JAX package's `jax_debug_nans`);
  - `assert_finite`: the count of non-finite elements as a device tensor,
    with no host read, so a step can log it without a sync;
  - `StepTimer`: steady-state step timing, the first `skip_first` steps
    left out, the device synchronised before each reading;
  - `chained_seconds`: seconds an iteration of `step(carry, *args) ->
    carry`, timed with CUDA events on the card and the host clock on CPU.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterable

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed code; on exit write `trace.json` (a Chrome
    trace) under `log_dir`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def enable_debug_nans(enable: bool = True):
    """Global NaN tripwire for backward passes (opt-in: it slows every
    step)."""
    torch.autograd.set_detect_anomaly(enable)


def _tensors(tree) -> Iterable[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def assert_finite(tree, name: str = "tree") -> torch.Tensor:
    """The number of non-finite elements among the floating tensors of
    `tree` (a tensor, or dicts, lists and tuples of them), as a 0-dim int64
    tensor on their device: 0 when clean. Nothing is read on the host."""
    counts = [(~torch.isfinite(t)).sum() for t in _tensors(tree)
              if t.is_floating_point()]
    if not counts:
        return torch.zeros((), dtype=torch.int64)
    return torch.stack([c.to(counts[0].device) for c in counts]).sum()


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class StepTimer:
    """Steady-state step timing with warm-up exclusion: `with
    timer.measure(): step()` synchronises the card (where there is one)
    before the clock starts and after the step, and the first
    `skip_first` steps do not count."""

    def __init__(self, skip_first: int = 1):
        self.skip_first = skip_first
        self._n = 0
        self._total = 0.0

    @contextlib.contextmanager
    def measure(self):
        _sync()
        t0 = time.perf_counter()
        yield
        _sync()
        dt = time.perf_counter() - t0
        self._n += 1
        if self._n > self.skip_first:
            self._total += dt

    @property
    def mean(self) -> float:
        return self._total / max(self._n - self.skip_first, 1)


def chained_seconds(step: Callable, carry0, *args, iters: int = 10,
                    passes: int = 1) -> float:
    """Seconds an iteration of `step(carry, *args) -> carry`: `iters`
    iterations chained through the carry, after one warm-up pass, the mean
    of `passes` timed passes. A CUDA carry is timed with CUDA events on
    its stream, a CPU one with the host clock."""
    on_card = isinstance(carry0, torch.Tensor) and carry0.is_cuda

    def run():
        c = carry0
        for _ in range(iters):
            c = step(c, *args)
        return c

    with torch.no_grad():
        run()
        dts = []
        for _ in range(max(1, passes)):
            if on_card:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                run()
                end.record()
                end.synchronize()
                dts.append(start.elapsed_time(end) / 1e3)
            else:
                t0 = time.perf_counter()
                run()
                dts.append(time.perf_counter() - t0)
    return sum(dts) / len(dts) / iters
