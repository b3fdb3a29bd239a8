"""Spans, counters, tracing and numerical tripwires.

Port of `horopose_tpu/core/profiling.py` in PyTorch's idiom, with the
program's own instrumentation:
  - `span(name)`: a stage of the program (the Predictor's call, the train
    step and their parts). With no recording active it returns one shared
    no-op context: no clock is read, nothing is allocated. Inside
    `record()` it appends (start_ns, end_ns, name, parent, root) to the
    recorder, on `time.time_ns()`, the clock `torch.profiler` stamps its
    events with, so a span lines up with the card's activity in a trace;
  - `record()`: makes one in-memory `Recorder` active for the process and
    yields it; its spans and the counters' gains are read after it exits;
  - `counters` and `count(name, n)`: process-wide integers, always on,
    read as differences (`counter_deltas`): the hand kernels' launches
    (`<wrapper>.launches`) and the bytes the Predictor sends to the card
    (`serve.upload_bytes`);
  - `trace(log_dir)`: a `torch.profiler` context over the CPU and, where
    there is one, the card, writing a Chrome trace (chrome://tracing,
    Perfetto) into `log_dir`; it records spans, and each span also opens
    `torch.profiler.record_function(name)`, so the trace shows the
    program's stages on the card's timeline;
  - `enable_debug_nans`: autograd anomaly detection, which raises where a
    backward produces NaN (the JAX package's `jax_debug_nans`);
  - `assert_finite`: the count of non-finite elements as a device tensor,
    with no host read, so a step can log it without a sync.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import torch

# (start_ns, end_ns, name, parent, root): parent is the list index of the
# enclosing span on the same thread (None for an outermost span), root the
# index of the outermost one, shared by every span of one call or step
SpanRecord = Tuple[int, int, str, Optional[int], int]

counters: Dict[str, int] = collections.defaultdict(int)
_counter_lock = threading.Lock()


def count(name: str, n: int = 1) -> None:
    """Add `n` to the process-wide counter `name`."""
    with _counter_lock:
        counters[name] += n


def counter_deltas(before: Mapping[str, int]) -> Dict[str, int]:
    """What each counter gained since `before`, a copy of `counters`."""
    with _counter_lock:
        now = dict(counters)
    return {k: v - before.get(k, 0) for k, v in now.items()}


class Recorder:
    """The spans of one `record()`, and after it exits the counters' gains
    over it (`counts`)."""

    def __init__(self, annotate: bool = False):
        self.spans: List[Optional[SpanRecord]] = []
        self.counts: Dict[str, int] = {}
        self.annotate = annotate
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> List[Tuple[int, int]]:
        """This thread's open spans, (index, root) each."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()
_active: Optional[Recorder] = None


class _Span:
    __slots__ = ("rec", "name", "index", "parent", "root", "start",
                 "annotation")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        stack = rec._stack()
        with rec._lock:
            self.index = len(rec.spans)
            rec.spans.append(None)
        self.parent, self.root = stack[-1] if stack else (None, self.index)
        stack.append((self.index, self.root))
        self.annotation = None
        if rec.annotate:
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        self.start = time.time_ns()
        return None

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        self.rec._stack().pop()
        self.rec.spans[self.index] = (self.start, end, self.name,
                                      self.parent, self.root)
        return False


def span(name: str):
    """A context over one stage of the program, recorded inside
    `record()` and `trace()`; elsewhere a shared no-op."""
    rec = _active
    if rec is None:
        return _NO_SPAN
    return _Span(rec, name)


@contextlib.contextmanager
def _recording(annotate: bool):
    global _active
    rec, before = Recorder(annotate), _active
    with _counter_lock:
        start = dict(counters)
    _active = rec
    try:
        yield rec
    finally:
        _active = before
        rec.counts = counter_deltas(start)


def record():
    """Record the program's spans in memory while the context is open;
    yields the `Recorder`. No file is written."""
    return _recording(annotate=False)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed code, with the program's spans as
    `record_function` ranges; on exit write `trace.json` (a Chrome trace)
    under `log_dir`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof, \
            _recording(annotate=True):
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
