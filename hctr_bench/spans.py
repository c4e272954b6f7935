"""The program's own spans and counters beside the card's trace: the
device's idle gaps put down to what the host was doing
(``idle_by_span``), the numbers read from the spans, and the check that
the spans' clock is the trace's.

    python3 hctr_bench/spans.py --workload <cell> --seed <n> --seconds <s> \\
        [--pairs 2]
    python3 hctr_bench/spans.py --clock

The first runs a cell as ``run.py --trace 1`` does (one set-up, then
windows of the seed's traffic), with the program's spans
(``handwritten_chinese_ocr_samples_torch.utils.profiling``) kept:
``--pairs`` pairs of untraced windows with the benchmark's own spans and
counters, as ``run.py``'s first window has them, the program's spans on
and off in turn (on, off, off, on, ...: each window's end-to-end number
and per-layer metrics give the spans' cost), then one window under the
card-only profiler with the spans on. It prints one JSON line:
the span metrics (``queue_wait_ms``, ``late_flush_ms``, ``seg_issue_ms``
from the first window with spans on, ``host_idle`` from the traced one),
``idle_by_span``, and each span's count and summed ms. ``--clock`` times
bf16 matmuls, each in a span that ends in ``torch.cuda.synchronize()``,
under the card-only profiler, and prints whether every kernel lies inside
its span on the spans' clock, and by how much.

``run.py`` keeps the program's spans only through a traced run's first
window, and only where one of the cell's metrics declares ``SPANS``;
both commands record them through ``system.program_spans``. Both exit
non-zero, printing no result, where there is no card; JAX is never
imported.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

import run as bench
import system
import trace
from manifest import Manifest

# the thread that issues the card's work: the caller's in a closed loop,
# the daemon's dispatcher under open-loop load
DISPATCH_THREAD = {"closed": "MainThread", "open": "hctr-serving"}
WAIT = "daemon.wait"          # the dispatcher with nothing to do
OUTSIDE = "outside"           # idle with no span of the thread open
TOP = 10
SEGMENT_STEPS = {"steps": ".decode.beam_lm_device:segment_steps"}


def timeline(spans, thread: str) -> List[Tuple[int, int, str]]:
    """``[(start ns, end ns, name)]``: the stretches of time in which some
    span of ``thread`` is open, each named by its innermost open span (the
    latest to start; a child starts after its parent or, on the same
    nanosecond, has the larger id)."""
    marks = []
    for s in spans:
        if s.thread == thread:
            marks.append((s.start_ns, 1, s))
            marks.append((s.end_ns, 0, s))
    marks.sort(key=lambda m: (m[0], m[1]))
    out, active, prev = [], {}, None
    for t, opens, s in marks:
        if active and t > prev:
            top = max(active.values(), key=lambda r: (r.start_ns, r.id))
            out.append((prev, t, top.name))
        prev = t
        if opens:
            active[s.id] = s
        else:
            active.pop(s.id, None)
    return out


def idle_gaps(events, window: Tuple[int, int]) -> List[Tuple[int, int]]:
    """The stretches of ``window`` (ns) in which no device operation of
    ``events`` (``trace.device_events``: name, start ns, duration ns, in
    start order) runs: the complement of their union, as ``trace.
    busy_and_gaps`` takes it."""
    t0, t1 = window
    gaps, end = [], t0
    for _, start, dur in events:
        stop = min(start + dur, t1)
        start = max(start, t0)
        if stop <= start:
            continue
        if start > end:
            gaps.append((end, start))
        end = max(end, stop)
    if end < t1:
        gaps.append((end, t1))
    return gaps


def idle_by_span(events, spans, window: Tuple[int, int],
                 thread: str) -> Dict[str, int]:
    """Nanoseconds of device idle in ``window`` by the innermost span of
    ``thread`` open at the time, and ``outside`` where none is; the values
    sum to the window's idle time."""
    segs = timeline(spans, thread)
    by: Dict[str, int] = defaultdict(int)
    j = 0
    for g0, g1 in idle_gaps(events, window):
        covered = 0
        while j < len(segs) and segs[j][1] <= g0:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < g1:
            a, b, name = segs[k]
            o = min(b, g1) - max(a, g0)
            if o > 0:
                by[name] += o
                covered += o
            k += 1
        by[OUTSIDE] += (g1 - g0) - covered
    return dict(by)


def top_seconds(by: Dict[str, int], top: int = TOP) -> Dict[str, float]:
    """``idle_by_span`` in seconds: the ``top`` longest names, the rest as
    ``other``, and ``outside``."""
    named = sorted(((k, v) for k, v in by.items() if k != OUTSIDE),
                   key=lambda kv: -kv[1])
    out = {k: v / 1e9 for k, v in named[:top]}
    if named[top:]:
        out["other"] = sum(v for _, v in named[top:]) / 1e9
    out[OUTSIDE] = by.get(OUTSIDE, 0) / 1e9
    return out


def host_idle_pct(by: Optional[Dict[str, int]], window_ns: int,
                  exclude: Sequence[str] = (WAIT,)) -> Optional[float]:
    """% of the window with the card idle inside the program's spans,
    those named in ``exclude`` left out."""
    if not by or window_ns <= 0:
        return None
    inside = sum(v for k, v in by.items() if k != OUTSIDE and k not in exclude)
    return 100.0 * inside / window_ns


def _ms(spans, name: str) -> List[float]:
    return [(s.end_ns - s.start_ns) / 1e6 for s in spans if s.name == name]


def queue_wait_ms(spans) -> Optional[float]:
    """95th percentile of the requests' ``daemon.queue`` spans (enqueue to
    the flush's pop), ms."""
    ms = _ms(spans, "daemon.queue")
    return float(np.percentile(ms, 95)) if ms else None


def late_flush_ms(spans) -> Optional[float]:
    """Mean of how long after it fell due (``due_ns``) each
    ``daemon.flush`` started, ms."""
    late = [(s.start_ns - s.attrs["due_ns"]) / 1e6 for s in spans
            if s.name == "daemon.flush" and s.attrs.get("due_ns") is not None]
    return float(np.mean(late)) if late else None


def seg_issue_ms(spans, steps: int) -> Optional[float]:
    """Host ms to issue a segment step: the ``search.segments`` spans'
    summed ms over the segment steps counted in the same window."""
    ms = _ms(spans, "search.segments")
    return sum(ms) / steps if ms and steps else None


def span_ms(spans) -> Dict[str, list]:
    """``name -> [count, summed ms]``."""
    out: Dict[str, list] = {}
    for s in spans:
        n, ms = out.get(s.name, [0, 0.0])
        out[s.name] = [n + 1, ms + (s.end_ns - s.start_ns) / 1e6]
    return out


def clock_skew(events, spans) -> dict:
    """Each device operation against the span whose interval holds its
    midpoint: how many lie wholly inside one, and the least time from a
    span's start to its first operation and from its last operation's end
    to the span's end, ns (the clocks' offset lies between minus the
    second and the first)."""
    spans = sorted(spans, key=lambda s: s.start_ns)
    starts = [s.start_ns for s in spans]
    first, last = {}, {}
    inside = 0
    for _, start, dur in events:
        mid = start + dur // 2
        i = int(np.searchsorted(starts, mid, side="right")) - 1
        if i < 0 or mid > spans[i].end_ns:
            continue
        s = spans[i]
        if s.start_ns <= start and start + dur <= s.end_ns:
            inside += 1
        first[i] = min(first.get(i, start), start)
        last[i] = max(last.get(i, start + dur), start + dur)
    lead = [first[i] - spans[i].start_ns for i in first]
    lag = [spans[i].end_ns - last[i] for i in last]
    return {"operations": len(events), "inside": inside,
            "spans_with_operations": len(first),
            "lead_ns_min": min(lead, default=None),
            "lag_ns_min": min(lag, default=None),
            "lead_ns_median": float(np.median(lead)) if lead else None,
            "lag_ns_median": float(np.median(lag)) if lag else None}


def _card():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card; this machine has none")
    dev = torch.device("cuda", 0)
    return dev, {"kind": torch.cuda.get_device_name(dev),
                 "power_limit_w": bench.power_limit_w()}


def clock(device, repeats: int = 20, size: int = 8192) -> dict:
    """``repeats`` spans, each around one ``size``-square bf16 matmul and
    a ``torch.cuda.synchronize()``, under the card-only profiler."""
    span = system.profiling().span
    x = torch.randn(size, size, device=device, dtype=torch.bfloat16)
    (x @ x).sum().item()
    with system.program_spans(True) as spans, \
            trace.card_profile(True) as prof:
        for _ in range(repeats):
            with span("clock"):
                x @ x
                torch.cuda.synchronize(device)
    events = [e for e in trace.device_events(prof)
              if not e[0].startswith(("Memcpy", "Memset"))]
    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "spans": len(spans), **clock_skew(events, spans)}


def traffic_window_ns(out: dict, now_ns: int) -> Tuple[int, int]:
    """A window's traffic (``out["t_start"]`` on ``time.perf_counter``,
    ``trace_window_s`` long) on the spans' clock, from ``now_ns`` read
    just now: the window ``run.py``'s idle share divides by, without the
    profiler's own work after it."""
    t0 = now_ns - round((time.perf_counter() - out["t_start"]) * 1e9)
    return t0, t0 + round(out["trace_window_s"] * 1e9)


def flush_reasons(spans) -> Dict[str, list]:
    """``reason -> [flushes, mean ms from falling due to starting]``."""
    late: Dict[str, list] = defaultdict(list)
    for s in spans:
        if s.name == "daemon.flush" and s.attrs.get("due_ns") is not None:
            late[s.attrs["reason"]].append((s.start_ns - s.attrs["due_ns"])
                                           / 1e6)
    return {k: [len(v), float(np.mean(v))] for k, v in late.items()}


def _window_numbers(manifest: Manifest, cell, out: dict, steps: int,
                    spans) -> dict:
    """A first window's end-to-end number and the per-layer metrics that
    read it (``metrics/<name>.py``), with the span metrics of ``spans``."""
    ctx = bench.Context(cell, out, out, None, None)
    per_layer = {k: v["value"]
                 for k, v in bench.per_layer(manifest, cell, ctx).items()}
    e2e = {k: v["value"] for k, v in bench.end_to_end(cell, out, 0.0).items()
           if k != "setup_s"}
    return {"end_to_end": e2e, "per_layer": per_layer,
            "segment_steps": steps, "failed": out["failed"],
            "queue_wait_ms": queue_wait_ms(spans),
            "late_flush_ms": late_flush_ms(spans),
            "seg_issue_ms": seg_issue_ms(spans, steps),
            "flush_reasons": flush_reasons(spans)}


def measure(manifest: Manifest, name: str, device, seed: int,
            seconds: float, pairs: int = 1) -> dict:
    """One set-up of cell ``name``, ``pairs`` pairs of first windows
    (spans on and off), then a window under the card-only profiler with
    the spans on."""
    cell = bench.Cell(manifest, name, device)
    cell.setup()
    thread = DISPATCH_THREAD[cell.traffic["kind"]]
    windows, first_spans = [], None
    # on, off, off, on, ...: a drift over the run weighs on both alike
    for k in range(2 * pairs):
        on = k % 4 in (0, 3)
        steps = system.read_counters(SEGMENT_STEPS)["steps"]
        out = cell.window(seed, seconds, spans=True, program_spans=on)
        steps = system.read_counters(SEGMENT_STEPS)["steps"] - steps
        spans = out["spans"]
        if on and first_spans is None:
            first_spans = spans
        windows.append({"spans_on": on,
                        **_window_numbers(manifest, cell, out, steps,
                                           spans)})
    traced = cell.window(seed, seconds, profile=True, program_spans=True)
    t0, t1 = traffic_window_ns(traced, system.profiling().now_ns())
    spans = traced["spans"]
    events = (trace.device_events(traced["prof"])
              if traced["prof"] is not None else [])
    busy_s, _ = trace.busy_and_gaps(events)
    by = idle_by_span(events, spans, (t0, t1), thread)
    idle_ns = sum(by.values())
    cell.free_program()
    return {
        "workload": name, "seed": seed, "seconds": seconds,
        "thread": thread,
        "metrics": {"queue_wait_ms": windows[0]["queue_wait_ms"],
                    "late_flush_ms": windows[0]["late_flush_ms"],
                    "seg_issue_ms": windows[0]["seg_issue_ms"],
                    "host_idle": host_idle_pct(by, t1 - t0)},
        "traced": {"window_s": (t1 - t0) / 1e9, "idle_s": idle_ns / 1e9,
                   "idle_pct": 100.0 * idle_ns / (t1 - t0),
                   # run.py's idle share: busy over its own window clock
                   "idle_pct_run": 100.0 * (1 - busy_s
                                            / traced["trace_window_s"]),
                   "failed": traced["failed"],
                   "idle_by_span": top_seconds(by),
                   "span_ms": span_ms(spans)},
        "windows": windows, "span_ms": span_ms(first_spans or [])}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--pairs", type=int, default=1)
    p.add_argument("--clock", action="store_true")
    args = p.parse_args(argv)
    device, card = _card()
    if args.clock:
        result = {"clock": clock(device), "device": card}
    else:
        if not args.workload:
            p.error("--workload or --clock")
        result = measure(Manifest.load(), args.workload, device, args.seed,
                         args.seconds, args.pairs)
        result["device"] = card
    bad = bench.banned_modules()
    if bad:
        print(f"refused: loaded {bad}", file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
