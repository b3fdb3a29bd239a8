"""The stage readings of `benchmark/stages.py` on made-up program spans
and kineto-like events, and the tool over the tiny CPU cells: the card's
idle time put down to the program's stages by overlap."""

from __future__ import annotations

import pytest

from benchmark import stages
from benchmark.tests.helpers import TINY_SERVE, TINY_TRAIN, tiny_root
from benchmark.tests.test_bench_trace import CUDA, Event
from benchmark.trace import Trace

SEED = 2 ** 31 + 4099


def _serve_spans(offset=0):
    """One call's program spans from `offset`: prep [0, 300) (its upload
    [100, 250)), forward [300, 700), return [700, 1000)."""
    rows = [(0, 1000, "serve.call", None), (0, 300, "serve.prep", 0),
            (100, 250, "serve.prep.upload", 1), (300, 700, "serve.forward", 0),
            (700, 1000, "serve.return", 0), (900, 1000, "serve.copy_back", 4)]
    base = 6 * (offset // 1000)
    return [(a + offset, b + offset, name,
             None if parent is None else parent + base, base)
            for a, b, name, parent in rows]


def _trace(events, window=(0, 1000), spans=()):
    return Trace(events, window, spans)


def test_a_gap_across_two_stages_is_split_by_overlap():
    # busy [0, 200) and [500, 1000): the gap [200, 500) crosses prep's end
    t = _trace([Event("k", CUDA, 0, 200), Event("k", CUDA, 500, 500)])
    out = stages.readings(t, _serve_spans(), {}, "serve")
    assert out["idle_prep_ms.serve"] == pytest.approx(100e-6)
    assert out["idle_forward_ms.serve"] == pytest.approx(200e-6)
    assert out["idle_return_ms.serve"] == 0


def test_descendants_count_toward_their_stage():
    spans = _serve_spans()
    # a child span that outlives its parent's interval still counts
    spans.append((950, 1100, "serve.copy_back.late", 5, 0))
    t = _trace([Event("k", CUDA, 0, 950)], window=(0, 1100))
    assert stages.idle_in(t, spans, ("serve.return",)) == \
        pytest.approx(150e-9)
    assert stages.host_intervals(spans, ("serve.return",)) == [(700, 1100)]


def test_readings_are_per_call_and_per_step():
    spans = _serve_spans() + _serve_spans(1000)
    t = _trace([Event("k", CUDA, 300, 400), Event("k", CUDA, 1300, 400)],
               window=(0, 2000))
    out = stages.readings(t, spans, {}, "serve")
    # each call: prep idle 300, return idle 300, forward busy
    assert out["idle_prep_ms.serve"] == pytest.approx(300e-6)
    assert out["idle_return_ms.serve"] == pytest.approx(300e-6)
    assert out["idle_forward_ms.serve"] == 0
    train = []
    for s in range(2):
        o, base = 1000 * s, 7 * s
        train += [(o, o + 1000, "train.step", None, base)] + [
            (o + 100 * i, o + 100 * (i + 1), f"step.{name}", base, base)
            for i, name in enumerate(("prepare_gt", "forward", "losses",
                                      "backward", "clip", "optimizer"))]
    t = _trace([Event("k", CUDA, 0, 2000)], window=(0, 2000))
    out = stages.readings(t, train, {}, "train")
    assert out["optimizer_ms.train"] == pytest.approx(100e-6)
    assert out["idle_forward_ms.train"] == out["idle_update_ms.train"] == 0


def test_nothing_is_read_without_card_events_or_program_spans():
    cpu_only = _trace([Event("aten::mm", CUDA, 0, 10, annotation=True)])
    assert stages.readings(cpu_only, _serve_spans(), {}, "serve") == {}
    busy = _trace([Event("k", CUDA, 0, 500)])
    assert stages.readings(busy, [], {}, "serve") == {}
    assert stages.readings(None, _serve_spans(), {}, "serve") == {}


def test_upload_rate_is_the_counter_over_the_copies_device_time():
    t = _trace([Event("Memcpy HtoD (Pageable -> Device)", CUDA, 100, 150),
                Event("Memcpy DtoH (Device -> Pageable)", CUDA, 900, 50),
                Event("k", CUDA, 300, 400)])
    out = stages.readings(t, _serve_spans(), {"serve.upload_bytes": 750},
                          "serve")
    assert out["upload_gb_per_s.serve"] == pytest.approx(5.0)
    assert "upload_gb_per_s.serve" not in stages.readings(
        t, _serve_spans(), {}, "serve")


def test_idle_by_innermost_span_adds_up_to_the_idle():
    t = _trace([Event("k", CUDA, 150, 100), Event("k", CUDA, 400, 200)],
               window=(-100, 1200))
    parts = stages.idle_by_span(t, _serve_spans())
    assert sum(parts.values()) == pytest.approx(1e3 * (t.window_s -
                                                       t.busy_s))
    assert parts["outside"] == pytest.approx(300e-6)
    assert parts["serve.prep.upload"] == pytest.approx(50e-6)
    assert parts["serve.prep"] == pytest.approx(150e-6)
    assert parts["serve.forward"] == parts["serve.return"] == \
        pytest.approx(200e-6)
    assert parts["serve.copy_back"] == pytest.approx(100e-6)


@pytest.mark.parametrize("workload", [TINY_SERVE, TINY_TRAIN])
def test_the_tool_names_program_stages_on_the_cpu(workload, tmp_path):
    """A tiny CPU cell through the tool: the stretch's spans are the
    program's and the idle by innermost span adds up to the window (a CPU
    run has no card activity: the whole window is one gap, and nothing
    is read); the recording cost runs in turns."""
    root, bench = tiny_root(tmp_path)
    out = stages.traced_cell(workload, SEED, 0.5, device="cpu",
                             bench=bench, root=root)
    assert out["result"]["correct"], out["result"]["checks"]
    assert out["readings"] == {}
    program = "serve." if workload == TINY_SERVE else "step."
    assert any(k.startswith(program) for k in out["idle_ms"])
    assert out["idle_sum_ms"] == pytest.approx(out["idle_total_ms"])
    cost = stages.recording_cost(workload, SEED, 2, device="cpu",
                                 bench=bench, root=root)
    assert len(cost["ms"]["on"]) == len(cost["ms"]["off"]) == 2
    assert cost["span_us"]["on"] > cost["span_us"]["off"] > 0
