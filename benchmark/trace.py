"""A profiled stretch of whole calls or steps, reduced to what the
per-layer metrics read.

`capture(fn, device, spans)` runs `fn` between two synchronises under
`torch.profiler` with the card's activity alone: recording every host op
as well would add tens of milliseconds of host time to a call and show
the profiler's own cost as idle card. The harness records its host spans
itself (`Spans`, wall-clock nanoseconds, the clock the profiler puts the
card's activity on), around the program's entries it calls. The
reduction reads the raw kineto events (the profiler's own event list is
slow to build for tens of thousands of kernels):
- device intervals: every kernel, copy and memset on the card (device
  type CUDA, user annotations left out), clipped to the window;
- busy time: the length of their union, so kernels that overlap count
  once; idle gaps: the window less that union;
- time by device operation name, and by kernel name for the rooflines;
- the host spans, to say what the host was doing during each idle gap.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch


class Spans:
    """Host spans (start ns, end ns, name) on the wall clock."""

    def __init__(self):
        self.spans: List[Tuple[int, int, str]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        start = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((start, time.time_ns(), name))


class Trace:
    def __init__(self, events, window: Tuple[int, int],
                 spans: Sequence[Tuple[int, int, str]] = ()):
        self.window = window
        self.spans = list(spans)
        lo, hi = window
        self.device: List[Tuple[int, int, str]] = []
        for e in events:
            if e.device_type() != torch.autograd.DeviceType.CUDA or \
                    e.is_user_annotation():
                continue
            start, end = e.start_ns(), e.start_ns() + e.duration_ns()
            if end > lo and start < hi:
                self.device.append((max(start, lo), min(end, hi), e.name()))
        self.device.sort()

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        merged: List[List[int]] = []
        for start, end, _ in self.device:
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def gaps(self) -> List[Tuple[int, int]]:
        out, t = [], self.window[0]
        for a, b in self.busy_intervals():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.window[1] > t:
            out.append((t, self.window[1]))
        return out

    def host_label(self, t: int, outer: str) -> str:
        """The innermost harness span open on the host at time t, `rest
        of <outer>` inside an `outer` span but no inner one, `between
        <outer>s` outside every span."""
        best = None
        for start, end, name in self.spans:
            if start <= t < end and (best is None or start >= best[0]):
                best = (start, name)
        if best is None:
            return f"between {outer}s"
        return f"rest of {outer}" if best[1] == outer else best[1]

    def kernel_s(self, names: Sequence[str]) -> Tuple[float, int]:
        """(seconds, launches) of the device kernels whose names contain
        any of `names`."""
        hits = [(b - a) for a, b, n in self.device
                if any(k in n for k in names)]
        return sum(hits) / 1e9, len(hits)

    def top_ops(self, n: int = 10) -> List[List]:
        total: Dict[str, int] = defaultdict(int)
        for a, b, name in self.device:
            total[name] += b - a
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], ns / 1e9] for name, ns in top]

    def top_gaps(self, outer: str, n: int = 10) -> List[List]:
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:n]
        return [[self.host_label(a, outer), (b - a) / 1e9] for a, b in gaps]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def capture(fn: Callable[[], None], device, spans: Spans) -> Optional[Trace]:
    """Profile `fn()` between synchronises: the window runs from the first
    synchronise's return to the second's."""
    on_card = torch.device(device).type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CUDA if on_card
            else torch.profiler.ProfilerActivity.CPU]
    _sync(device)
    with torch.profiler.profile(activities=acts) as prof:
        start = time.time_ns()
        fn()
        _sync(device)
        end = time.time_ns()
    return Trace(prof.profiler.kineto_results.events(), (start, end),
                 spans.spans)
