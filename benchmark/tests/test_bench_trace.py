"""The trace reduction on made-up kineto events: the union of device
intervals, the idle gaps and what the host was doing in each, kernel
times by name."""

from __future__ import annotations

import torch

from benchmark.trace import Spans, Trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Event:
    def __init__(self, name, device, start, dur, annotation=False):
        self._v = (name, device, start, dur, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]


def _trace():
    spans = [(0, 500, "call"), (0, 100, "preprocess"), (100, 400, "forward"),
             (500, 1000, "call")]
    events = [
        Event("aten::conv", CPU, 120, 10),                  # a host op
        Event("gpu_user_annotation", CUDA, 0, 1000, True),  # not a kernel
        Event("soft_argmax_3d_fwd_kernel<float>", CUDA, 150, 50),
        Event("conv_kernel", CUDA, 180, 120),                # overlaps
        Event("Memcpy HtoD", CUDA, 600, 100),
        Event("conv_kernel", CUDA, 950, 100),                # past the end
    ]
    return Trace(events, (0, 1000), spans)


def test_busy_is_the_union_clipped_to_the_window():
    t = _trace()
    assert t.busy_intervals() == [(150, 300), (600, 700), (950, 1000)]
    assert abs(t.busy_s - 300e-9) < 1e-15
    assert abs(t.window_s - 1e-6) < 1e-15


def test_gaps_are_labelled_by_the_host_span():
    t = _trace()
    assert t.gaps() == [(0, 150), (300, 600), (700, 950)]
    gaps = t.top_gaps("call")
    # each gap under the innermost span open when it starts, longest first
    assert [g[0] for g in gaps] == ["forward", "rest of call", "preprocess"]
    assert abs(gaps[0][1] - 300e-9) < 1e-15


def test_kernels_by_name_and_top_ops():
    t = _trace()
    s, n = t.kernel_s(["soft_argmax_3d_fwd_kernel"])
    assert n == 1 and abs(s - 50e-9) < 1e-15
    top = t.top_ops()
    assert top[0][0] == "conv_kernel" and abs(top[0][1] - 170e-9) < 1e-15
    assert {name for name, _ in top} == {
        "conv_kernel", "Memcpy HtoD", "soft_argmax_3d_fwd_kernel<float>"}


def test_spans_record_wall_clock_nanoseconds():
    s = Spans()
    with s.span("outer"):
        with s.span("inner"):
            pass
    (a0, a1, inner), (b0, b1, outer) = s.spans
    assert (inner, outer) == ("inner", "outer")
    assert b0 <= a0 <= a1 <= b1
