"""The port's spans and counters (``utils/profiling``) on the CPU: off, they
record nothing; on, each thread keeps its own parents, the daemon's queue
and flush spans say why and when each flush fell due, the skip search's
spans nest under the route's host tail and ``segment_steps`` counts its
steps, ``profile_trace`` names them in its Chrome trace, the spans' clock
is the profiler's, and the served texts do not change. The engines are
``demo/hard``'s trained ``hctr-tiny`` and 128d/3L char LM in f32."""

import json
import os
import threading

import numpy as np
import pytest
import torch

from handwritten_chinese_ocr_samples_torch.core.codec import (
    CTCCodec, load_chars_list)
from handwritten_chinese_ocr_samples_torch.decode import (
    adaptive, beam_lm_device)
from handwritten_chinese_ocr_samples_torch.decode.lm_interface import (
    TorchLMBackend)
from handwritten_chinese_ocr_samples_torch.lm.io import load_lm
from handwritten_chinese_ocr_samples_torch.models.registry import (
    get_model_info)
from handwritten_chinese_ocr_samples_torch.serve.daemon import ServingDaemon
from handwritten_chinese_ocr_samples_torch.serve.engine import ServingEngine
from handwritten_chinese_ocr_samples_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "handwritten_chinese_ocr_samples_torch",
                      "assets", "demo_hard")
DATA = os.path.join(REPO, "demo", "hard", "data")
WIDTHS = (512, 1024, 1600)


@pytest.fixture(autouse=True)
def spans_off():
    """Each test starts and ends with spans off and none kept."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.enable(False)
    profiling.collect()
    yield
    profiling.enable(False)
    profiling.collect()
    torch.set_num_threads(n)


def _engine(**kw):
    chars_file = os.path.join(DATA, "chars_list.txt")
    model, _ = get_model_info("hctr-tiny", chars_list_file=chars_file)
    state = torch.load(os.path.join(ASSETS, "hctr_tiny.pt"),
                       weights_only=True)
    return ServingEngine(model, state, CTCCodec(load_chars_list(chars_file)),
                         widths=WIDTHS, device="cpu", **kw)


@pytest.fixture(scope="module")
def greedy():
    return _engine()


@pytest.fixture(scope="module")
def lines():
    """The first test lines of ``demo/hard``, one ``(h, w)`` uint8 each."""
    import cv2
    test = os.path.join(DATA, "test")
    return [cv2.imread(os.path.join(test, f), cv2.IMREAD_GRAYSCALE)
            for f in sorted(os.listdir(test))[:8]]


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r.name, []).append(r)
    return out


def test_off_records_nothing_and_returns_the_shared_noop():
    assert profiling.span("engine.dispatch") is profiling.NOOP
    assert profiling.span("x", batch=3) is profiling.NOOP
    with profiling.span("x"):
        profiling.record("daemon.queue", 1, 2, request=0)
    assert profiling.collect() == []
    profiling.enable()
    with profiling.span("x", batch=3) as s:
        assert s is not profiling.NOOP
    rec, = profiling.collect()
    assert rec.name == "x" and rec.attrs == {"batch": 3}
    assert rec.start_ns <= rec.end_ns and rec.parent == 0
    assert profiling.collect() == []


def test_nested_spans_on_two_threads_keep_their_own_parents():
    """Two threads hold their spans open at the same time: each inner
    span's parent is its own thread's outer span."""
    profiling.enable()
    both_open = threading.Barrier(2, timeout=30)

    def work(tag):
        with profiling.span(f"{tag}.outer"):
            with profiling.span(f"{tag}.inner"):
                both_open.wait()
                with profiling.span(f"{tag}.leaf"):
                    pass
    threads = [threading.Thread(target=work, args=(t,), name=f"worker-{t}")
               for t in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    recs = {r.name: r for r in profiling.collect()}
    assert len(recs) == 6
    for tag in ("a", "b"):
        outer, inner, leaf = (recs[f"{tag}.{k}"]
                              for k in ("outer", "inner", "leaf"))
        assert outer.parent == 0
        assert inner.parent == outer.id and leaf.parent == inner.id
        assert {outer.thread, inner.thread, leaf.thread} == {f"worker-{tag}"}
        assert outer.start_ns <= inner.start_ns <= leaf.start_ns
        assert leaf.end_ns <= inner.end_ns <= outer.end_ns
    # the two threads' spans overlap in time
    assert recs["a.inner"].start_ns < recs["b.leaf"].end_ns
    assert recs["b.inner"].start_ns < recs["a.leaf"].end_ns


def test_daemon_queue_and_flush_spans(greedy, lines):
    """One ``daemon.queue`` span a request; a full batch flushes ``full``,
    a lone request ``deadline``, and what is queued at the close
    ``drain``, each flush starting once it fell due."""
    profiling.enable()
    daemon = ServingDaemon(greedy, batch_size=4, max_delay_ms=60_000)
    futs = [daemon.submit_array(a) for a in lines[:4]]      # fills a batch
    assert all(f.result(timeout=120) is not None for f in futs)
    futs += [daemon.submit_array(a) for a in lines[4:6]]    # drained
    daemon.close()
    with ServingDaemon(greedy, batch_size=4, max_delay_ms=20) as lone:
        futs.append(lone.submit_array(lines[6]))            # deadline
        futs[-1].result(timeout=120)
    spans = _by_name(profiling.collect())
    queue, flush = spans["daemon.queue"], spans["daemon.flush"]
    assert len(queue) == 7
    assert sorted(q.attrs["request"] for q in queue[:6]) == list(range(6))
    assert all(q.start_ns <= q.end_ns and q.parent == 0 for q in queue)
    assert {q.thread for q in queue} == {threading.current_thread().name}
    reasons = [f.attrs["reason"] for f in flush]
    assert reasons == ["full", "drain", "deadline"]
    assert [f.attrs["rows"] for f in flush] == [4, 2, 1]
    for f in flush:
        assert f.thread == "hctr-serving" and f.parent == 0
        assert f.attrs["due_ns"] is not None
        assert f.start_ns >= f.attrs["due_ns"]
        assert f.attrs["bucket"] in WIDTHS
    assert flush[0].attrs["requests"] == [0, 1, 2, 3]
    assert flush[1].attrs["requests"] == [4, 5]
    # a request's queue span ends when its flush pops it
    ended = {q.attrs["request"]: q.end_ns for q in queue[:6]}
    assert all(ended[r] <= flush[0].start_ns for r in range(4))
    assert flush[2].start_ns - flush[2].attrs["due_ns"] < 30e9
    # the flush's engine work nests under it, on the dispatcher's thread
    dispatch = spans["engine.dispatch"]
    assert [d.parent for d in dispatch] == [f.id for f in flush]
    assert "daemon.wait" in spans


def test_daemon_serves_the_same_texts_with_spans_on(greedy, lines):
    def serve():
        with ServingDaemon(greedy, batch_size=4, max_delay_ms=30) as d:
            futs = [d.submit_array(a) for a in lines]
            return [f.result(timeout=120) for f in futs]
    off = serve()
    profiling.enable()
    on = serve()
    assert on == off and any(off)
    assert len(_by_name(profiling.collect())["daemon.queue"]) == len(lines)


def test_engine_spans_nest(greedy, lines):
    profiling.enable()
    w, x = greedy.preprocess_array(lines[0])
    greedy.infer_batch(np.concatenate([x, x]))
    recs = profiling.collect()
    spans = {r.name: r for r in recs}
    top = spans["engine.dispatch"]
    for child in ("engine.h2d", "engine.forward", "route.dispatch"):
        assert spans[child].parent == top.id
        assert top.start_ns <= spans[child].start_ns
        assert spans[child].end_ns <= top.end_ns
    assert spans["route.texts"].parent == spans["route.finalize"].id
    assert spans["route.finalize"].parent == 0
    assert isinstance(top.attrs["batch"], int)


def test_skip_search_spans_and_segment_steps(lines, monkeypatch):
    """``segment_steps`` advances by the steps the searches ran (one
    ``on_select`` call a step), which is each group's largest segment
    count (``count_segments``, on the host); the ``search.*`` spans nest
    under ``route.finalize``."""
    engine = _engine(decode_method="beam-search", use_lm_pred=True,
                     use_lm_score=True, skip_search=True, lm_f32=True,
                     lm_group=2, lm_panelty=0.8, len_bonus=0.0,
                     lm=TorchLMBackend(*load_lm(os.path.join(ASSETS, "lm")),
                                       device="cpu"))
    steps, groups = [0], []
    real_search = adaptive.AdaptiveLMBeam.search
    real_shards = adaptive.AdaptiveLMBeam.decode_shards

    def counted(self, group, clm=None, **extra):
        def on_select(*_):
            steps[0] += 1
        return real_search(self, group, clm, on_select=on_select, **extra)

    def kept(self, parts):
        out = real_shards(self, parts)
        _, ci, *_, n_above = parts[0]
        per_line = beam_lm_device.count_segments(
            ci, n_above, unknown_id=self.unknown_id, run_max=self.run_max)
        groups.extend(per_line.reshape(-1, self.last_group).max(1))
        return out

    monkeypatch.setattr(adaptive.AdaptiveLMBeam, "search", counted)
    monkeypatch.setattr(adaptive.AdaptiveLMBeam, "decode_shards", kept)
    profiling.enable()
    before = beam_lm_device.segment_steps
    texts, _ = engine.infer_arrays(lines[:4], batch_size=4)
    moved = beam_lm_device.segment_steps - before
    assert any(texts) and moved > 0
    assert moved == steps[0] == sum(groups)
    recs = profiling.collect()
    by_id = {r.id: r for r in recs}
    spans = _by_name(recs)

    def ancestors(r):
        out = []
        while r.parent:
            r = by_id[r.parent]
            out.append(r.name)
        return out
    for name in ("search.sizing", "search.decode", "search.group",
                 "search.schedule", "search.segments", "search.overflow"):
        assert name in spans, name
        for r in spans[name]:
            assert "route.finalize" in ancestors(r), name
    assert len(spans["search.group"]) == len(groups)
    for r in spans["search.schedule"] + spans["search.segments"]:
        assert by_id[r.parent].name == "search.group"
    assert [by_id[r.parent].name for r in spans["search.group"]] == \
        ["search.decode"] * len(groups)
    assert {r.attrs["attempt"] for r in spans["search.decode"]} == {0}


def test_profile_trace_names_the_spans(greedy, lines, tmp_path):
    """Inside ``profile_trace`` the spans enter ``record_function``, so the
    Chrome trace names them, and nothing is kept unless enabled."""
    w, x = greedy.preprocess_array(lines[0])
    with profiling.profile_trace(str(tmp_path)):
        greedy.infer_batch(x)
    assert profiling.span("engine.dispatch") is profiling.NOOP
    assert profiling.collect() == []
    trace, = os.listdir(tmp_path)
    with open(tmp_path / trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"engine.dispatch", "engine.forward", "route.finalize",
            "route.texts"} <= names


def test_spans_run_on_the_profilers_clock():
    """Every operation the profiler records inside a span lies inside the
    span's interval on ``now_ns()``."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(256, 256)
    profiling.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("clock"):
            for _ in range(4):
                x = torch.mm(x, x).tanh()
    rec, = profiling.collect()
    ops = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::mm"]
    assert len(ops) == 4
    for e in ops:
        assert rec.start_ns <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= rec.end_ns
