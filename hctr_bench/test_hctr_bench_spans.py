"""``spans.py`` without a card: the join of the card's idle gaps with the
program's spans on synthetic events (a gap split across two spans and one
outside every span, ``daemon.wait`` left out of the host's share, another
thread's spans ignored), each number read from the spans (None where its
spans are missing), the clock check's arithmetic, and one set-up of the
tiny skip-search and open-loop cells driven end to end on the CPU. And
``run.py``'s windows: a metric that declares the port's counters and
spans gets their change over the traced run's first window and the spans
kept in it, and a cell whose metrics declare neither keeps no span."""

import contextlib
import os
import time

import pytest
import torch

import run as bench
import spans as sp
import trace
from handwritten_chinese_ocr_samples_torch.utils import profiling
from handwritten_chinese_ocr_samples_torch.utils.profiling import SpanRecord
from manifest import Manifest
from test_hctr_bench_cells import tiny  # noqa: F401


def rec(name, start, end, id_, parent=0, thread="T", **attrs):
    return SpanRecord(name, start, end, id_, parent, thread, attrs)


def op(start, end):
    return ("kernel", start, end - start)


def test_idle_by_span_splits_gaps_and_ignores_other_threads():
    # the card runs [0, 10), [30, 40), [70, 80) of the window [0, 100)
    events = [op(0, 10), op(30, 40), op(70, 80)]
    spans = [rec("a", 5, 50, 1), rec("b", 20, 35, 2, parent=1),
             rec("c", 60, 90, 3),
             rec("elsewhere", 0, 100, 4, thread="U")]
    by = sp.idle_by_span(events, spans, (0, 100), "T")
    # [10, 30): a then its child b; [40, 70): a, none, c; [80, 100): c, none
    assert by == {"a": 20, "b": 10, "c": 20, sp.OUTSIDE: 20}
    assert sum(by.values()) == 70
    assert sp.idle_gaps(events, (0, 100)) == [(10, 30), (40, 70), (80, 100)]
    # the other thread's span alone covers nothing of T's
    only_u = sp.idle_by_span(events, spans[3:], (0, 100), "T")
    assert only_u == {sp.OUTSIDE: 70}
    assert sp.idle_by_span(events, spans, (0, 100), "U") == {
        "elsewhere": 70, sp.OUTSIDE: 0}


def test_idle_gaps_clip_to_the_window_and_overlaps_count_once():
    events = [op(-5, 3), op(2, 8), op(4, 6), op(12, 30)]
    assert sp.idle_gaps(events, (0, 20)) == [(8, 12)]
    assert sp.idle_gaps([], (0, 20)) == [(0, 20)]


def test_host_idle_leaves_out_the_dispatcher_waiting():
    by = {"daemon.wait": 30, "engine.h2d": 10, "route.d2h_wait": 5,
          sp.OUTSIDE: 5}
    assert sp.host_idle_pct(by, 100) == 15.0
    assert sp.host_idle_pct(by, 100, exclude=()) == 45.0
    idle = 100.0 * sum(by.values()) / 100
    assert sp.host_idle_pct(by, 100) <= idle
    assert sp.host_idle_pct({}, 100) is None
    assert sp.host_idle_pct(None, 100) is None


def test_top_seconds_keeps_every_nanosecond():
    by = {f"s{i}": (i + 1) * 10 ** 9 for i in range(12)}
    by[sp.OUTSIDE] = 5 * 10 ** 8
    top = sp.top_seconds(by)
    assert list(top)[:2] == ["s11", "s10"] and len(top) == 12
    assert top["other"] == 3.0 and top[sp.OUTSIDE] == 0.5
    assert sum(top.values()) == pytest.approx(sum(by.values()) / 1e9)


def test_readers_read_the_spans_and_return_none_without_them():
    ms = 10 ** 6
    queue = [rec("daemon.queue", 0, (k + 1) * ms, k + 1, request=k)
             for k in range(20)]
    flushes = [rec("daemon.flush", 10 * ms, 20 * ms, 30, due_ns=7 * ms),
               rec("daemon.flush", 30 * ms, 40 * ms, 31, due_ns=29 * ms),
               rec("daemon.flush", 50 * ms, 60 * ms, 32, due_ns=None)]
    segs = [rec("search.segments", 0, 6 * ms, 40),
            rec("search.segments", 10 * ms, 14 * ms, 41)]
    assert sp.queue_wait_ms(queue) == pytest.approx(19.05)
    assert sp.late_flush_ms(flushes) == pytest.approx(2.0)
    assert sp.seg_issue_ms(segs, 5) == pytest.approx(2.0)
    assert sp.queue_wait_ms(flushes + segs) is None
    assert sp.late_flush_ms(queue + flushes[2:]) is None
    assert sp.seg_issue_ms(queue, 5) is None
    assert sp.seg_issue_ms(segs, 0) is None
    assert sp.span_ms(segs) == {"search.segments": [2, 10.0]}


def test_clock_skew_counts_operations_inside_their_spans():
    spans = [rec("clock", 100, 200, 1), rec("clock", 300, 400, 2)]
    events = [op(110, 150), op(160, 190), op(320, 390), op(190, 230)]
    got = sp.clock_skew(events, spans)
    assert got["operations"] == 4 and got["inside"] == 3
    assert got["spans_with_operations"] == 2
    assert got["lead_ns_min"] == 10 and got["lag_ns_min"] == 10


class HostEvent:
    """``torch.cuda.Event`` on the host clock, for the benchmark's timed
    forward on the CPU."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


@pytest.fixture
def cpu_profile(monkeypatch):
    """The card-only profiler stood in for by a CPU one (the traced window
    then holds no device operation and is idle throughout), and CUDA
    events by host ones."""
    from torch.profiler import ProfilerActivity, profile

    @contextlib.contextmanager
    def cpu(on):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            yield prof
    monkeypatch.setattr(trace, "card_profile", cpu)
    monkeypatch.setattr(torch.cuda, "Event", HostEvent)


def test_measure_skip_search_cell_on_the_cpu(tiny, cpu_profile):  # noqa: F811
    got = sp.measure(tiny, "ss", "cpu", 5, 0.5)
    m = got["metrics"]
    assert m["seg_issue_ms"] > 0 and m["queue_wait_ms"] is None
    on, off = got["windows"]
    assert on["spans_on"] and not off["spans_on"]
    assert on["segment_steps"] > 0 and off["seg_issue_ms"] is None
    assert "lm_lines_per_s" in on["end_to_end"]
    traced = got["traced"]
    # no device operation: the window is idle throughout, nearly all of it
    # inside the program's spans on the caller's thread
    assert sum(traced["idle_by_span"].values()) == pytest.approx(
        traced["window_s"])
    assert 0 < m["host_idle"] <= 100.0
    assert "search.segments" in traced["idle_by_span"]
    assert got["span_ms"]["search.segments"][0] > 0


def test_measure_open_cell_on_the_cpu(tiny, cpu_profile):  # noqa: F811
    got = sp.measure(tiny, "open", "cpu", 5, 1.0)
    m = got["metrics"]
    assert m["queue_wait_ms"] > 0 and m["late_flush_ms"] >= 0
    assert m["seg_issue_ms"] is None
    assert got["thread"] == "hctr-serving"
    assert "daemon.wait" in got["traced"]["idle_by_span"]
    assert m["host_idle"] < got["traced"]["idle_pct"]
    assert got["span_ms"]["daemon.queue"][0] == 20


# a metric of a test's own that declares two of the port's counters (one
# relative to the port) and its spans
PROBE = """
COUNTERS = {"steps": ".decode.beam_lm_device:segment_steps",
            "k4": "handwritten_chinese_ocr_samples_torch.ops.cache_gather:"
                  "launches"}
SPANS = True
seen = []


def read(ctx):
    seen.append(ctx)
    return ctx.counter("steps")
"""


def _windows(manifest, cell_name, monkeypatch, seconds=0.5):
    """A set-up of ``cell_name``, then a traced run's two windows, noting
    whether spans were kept at each batch the engine dispatched (in the
    first window, in the second)."""
    from handwritten_chinese_ocr_samples_torch.serve.engine import (
        ServingEngine)
    cell = bench.Cell(manifest, cell_name, "cpu")
    cell.setup()
    kept = []
    real = ServingEngine.dispatch_batch

    def noted(self, batch):
        kept.append(profiling.recording())
        return real(self, batch)
    monkeypatch.setattr(ServingEngine, "dispatch_batch", noted)
    out = cell.window(5, seconds, spans=True)
    first = len(kept)
    traced = cell.window(5, seconds, profile=True)
    return cell, out, traced, kept[:first], kept[first:]


def test_declared_counters_and_spans_reach_the_metric(tiny, cpu_profile,  # noqa: F811
                                                      monkeypatch):
    os.makedirs(os.path.join(tiny.folder, "metrics"))
    with open(os.path.join(tiny.folder, "metrics", "probe.ss.py"), "w") as f:
        f.write(PROBE)
    data = dict(tiny.data, per_layer=[{"name": "probe.ss", "unit": "steps",
                                       "workloads": ["ss"]}])
    manifest = Manifest(data, folder=tiny.folder)
    cell, out, traced, first, second = _windows(manifest, "ss",
                                                monkeypatch)
    assert cell.want_spans and set(cell.counter_paths) == {"steps", "k4"}
    assert first and all(first) and second and not any(second)
    assert not profiling.recording()
    got = bench.per_layer(manifest, cell,
                          bench.Context(cell, out, traced, None, None))
    ctx = cell.metrics["probe.ss"].seen[-1]
    assert got["probe.ss"]["value"] == ctx.counter("steps") > 0
    # the same window's change as the launch counters' own
    assert ctx.counter("k4") == ctx.counters["k4"]
    assert {"search.segments", "engine.dispatch"} <= {s.name
                                                      for s in ctx.spans}
    assert traced["spans"] == [] and traced["deltas"] == {}
    with pytest.raises(KeyError):
        ctx.counter("undeclared")


@pytest.mark.parametrize("cell_name", ["ss", "open"])
def test_no_span_is_kept_where_no_metric_asks(tiny, cpu_profile,  # noqa: F811
                                              monkeypatch, cell_name):
    cell, out, traced, first, second = _windows(tiny, cell_name,
                                                monkeypatch, seconds=1.0)
    assert first and second and not any(first + second)
    assert not cell.want_spans and cell.counter_paths == {}
    assert out["spans"] == [] and out["deltas"] == {}
    assert traced["spans"] == []
