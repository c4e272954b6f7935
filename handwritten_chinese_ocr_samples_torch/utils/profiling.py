"""Profiling (the JAX package's ``utils/profiling.py``), and the port's spans.

``profile_trace`` wraps a region in ``torch.profiler`` with the CPU and, on
a machine with a card, the CUDA activities, and writes a Chrome trace into
``log_dir`` (``<host>_<pid>.<ns>.pt.trace.json``, as
``torch.profiler.tensorboard_trace_handler`` names it: TensorBoard's
profiler plugin and Perfetto read it). The JAX module's ``StepTimer`` is
not copied: only a test of the JAX package calls it, and no path of the
port times steps on the host.

**Spans.** ``span(name, **attrs)`` brackets the program's work at a layer
boundary, never a kernel launch or a search step:

  * ``daemon.queue`` (a request's enqueue to its pop; ``request``,
    ``bucket``), ``daemon.flush`` (pop to futures set; ``reason`` ``full``,
    ``deadline`` or ``drain``, ``rows``, ``bucket``, ``due_ns`` when the
    flush fell due, ``requests``), ``daemon.wait`` (the dispatcher waiting
    on its condition): ``serve/daemon.py``;
  * ``engine.dispatch`` (``batch``) over ``engine.h2d``, ``engine.forward``
    and ``route.dispatch``; ``route.finalize`` over ``route.d2h_wait`` and
    ``route.texts``: ``serve/engine.py``, ``decode/routes.py``;
  * ``search.sizing``, ``search.decode`` (``attempt``: 1 after a KV
    overflow) over ``search.group`` (``search.schedule``,
    ``search.segments``) and ``search.overflow``: ``decode/adaptive.py``,
    ``decode/beam_lm_device.py``.

They are off unless enabled: ``span`` then checks one module flag and
returns a shared no-op, with no clock read and nothing kept. ``enable()``
keeps every finished span in memory (``SpanRecord``: name, start and end,
its id and its parent's on the thread's stack, the thread, the attributes)
until ``collect()`` returns and clears them. Inside ``profile_trace`` each
span also enters ``torch.profiler.record_function(name)``, so that the
Chrome trace names the program's layers. ``now_ns()`` is every span's
clock: the clock of the ``torch.profiler`` events' ``start_ns()``, so that
spans and a profiler trace of the card join.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Iterator, List, NamedTuple

import torch

_recording = False      # ``enable``: keep finished spans
_named = 0              # open ``profile_trace`` regions: record_function too
_active = False         # either: the one flag ``span`` reads when off
_records: List["SpanRecord"] = []
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()


class SpanRecord(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int         # 0: no enclosing span on the thread
    thread: str
    attrs: dict


def now_ns() -> int:
    """The spans' clock: epoch nanoseconds, the clock of the
    ``torch.profiler`` events' ``start_ns()``."""
    return time.time_ns()


def enable(on: bool = True) -> None:
    """Keep (``on``) or stop keeping finished spans."""
    global _recording
    _recording = bool(on)
    _update()


def recording() -> bool:
    """Whether finished spans are kept (for attributes that cost work)."""
    return _recording


def collect() -> List[SpanRecord]:
    """The spans kept since the last call, in the order they ended."""
    global _records
    with _lock:
        out, _records = _records, []
    return out


def record(name: str, start_ns: int, end_ns: int, thread: str = "",
           **attrs) -> None:
    """Keep a span that no one ``with`` block brackets (one that starts on
    one thread and ends on another), with no parent; ``thread`` defaults
    to the caller's."""
    if _recording:
        _keep(SpanRecord(name, start_ns, end_ns, next(_ids), 0,
                         thread or threading.current_thread().name, attrs))


def span(name: str, **attrs):
    """A context manager that brackets one piece of the program's work
    (the shared no-op while spans are off)."""
    if not _active:
        return NOOP
    return _Span(name, attrs)


NOOP = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "start_ns", "_fn")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else 0
        self.id = next(_ids)
        stack.append(self.id)
        self._fn = None
        if _named:
            self._fn = torch.profiler.record_function(self.name)
            self._fn.__enter__()
        self.start_ns = now_ns()
        return self

    def __exit__(self, *exc):
        end = now_ns()
        if self._fn is not None:
            self._fn.__exit__(*exc)
        _stack().pop()
        if _recording:
            _keep(SpanRecord(self.name, self.start_ns, end, self.id,
                             self.parent, threading.current_thread().name,
                             self.attrs))
        return False


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _keep(rec: SpanRecord) -> None:
    with _lock:
        _records.append(rec)


def _update() -> None:
    global _active
    _active = _recording or _named > 0


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator["torch.profiler.profile"]:
    """``torch.profiler`` over the enclosed region, the program's spans
    named in it; on exit the card's queued work is waited for and the
    trace is written into ``log_dir``."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    global _named
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        _named += 1
        _update()
        try:
            yield prof
        finally:
            _named -= 1
            _update()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
