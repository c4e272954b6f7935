"""Reading a card-only ``torch.profiler`` trace: kernel sums by name, the
device's busy time, and the breakdown the result line carries.

``device_kernels`` is a frozen copy of the port's smoke-run parser (raw
events of the trace, summed by name; ``key_averages`` would build a Python
object an event first). Busy time is the union of the device operations'
intervals, so that two overlapping operations count once.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple


def device_events(prof) -> List[Tuple[str, int, int]]:
    """``(name, start ns, duration ns)`` of every device operation
    (kernel, copy, fill) in the trace, in start order."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            out.append((e.name(), e.start_ns(), e.duration_ns()))
    out.sort(key=lambda ev: ev[1])
    return out


def device_kernels(events) -> Dict[str, Tuple[float, int]]:
    """``name -> (device ms, launches)``, summed over the events."""
    sums: Dict[str, Tuple[float, int]] = {}
    for name, _, dur in events:
        ms, n = sums.get(name, (0.0, 0))
        sums[name] = (ms + dur / 1e6, n + 1)
    return sums


def busy_and_gaps(events, top: int = 10):
    """``(busy s, longest idle gaps)``: the union of the operations'
    intervals, and the ``top`` longest gaps between them, each named by
    the operations on either side (``"<before> -> <after>"``)."""
    busy_ns, gaps = 0, []
    end, last = None, None
    for name, start, dur in events:
        stop = start + dur
        if end is None:
            busy_ns += dur
        elif start >= end:
            busy_ns += dur
            gaps.append((start - end, f"{last[:60]} -> {name[:60]}"))
        elif stop > end:
            busy_ns += stop - end
        if end is None or stop > end:
            end, last = stop, name
    gaps.sort(key=lambda g: -g[0])
    return busy_ns / 1e9, [[n, ns / 1e9] for ns, n in gaps[:top]]


def breakdown(kernels: Dict[str, Tuple[float, int]], gaps) -> dict:
    """The result line's ``breakdown``: the 10 device operations that took
    most time (seconds) and the 10 longest idle gaps."""
    ops = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    return {"device_ops": [[name[:120], ms / 1e3] for name, (ms, _) in ops],
            "idle_gaps": gaps[:10]}


@contextlib.contextmanager
def card_profile(on: bool):
    """A profiler over the card's activity alone while the block runs
    (nothing with ``on`` false); yields the profiler or None."""
    if not on:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield prof
