"""Continuous serving daemon: a deadline-batched request queue per bucket
(the JAX package's ``serve/daemon.py``).

Requests arrive one at a time; the daemon accumulates them per width bucket
and flushes a bucket when a full batch has formed or its oldest request has
waited ``max_delay_ms``. Results are delivered through per-request futures
and equal what ``ServingEngine.infer_files`` returns for the same image.

Threading model: callers preprocess on their own thread (``submit``), and a
single dispatcher thread owns the device.

Spans (``utils/profiling``, off unless enabled): ``daemon.queue`` per
request, ``daemon.flush`` per flush with the reason it fell due and when,
``daemon.wait`` while the dispatcher waits. The deadlines run on
``time.monotonic()``; the spans' clock is read only while spans are kept.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Deque, Dict, List, Tuple

import numpy as np

from ..utils import profiling
from ..utils.profiling import span
from .engine import ServingEngine


class ServingDaemon:
    """Deadline-batched continuous serving over a ``ServingEngine``.

    ``batch_size`` is the flush size per width bucket (partial flushes are
    padded by repetition); ``max_delay_ms`` bounds per-request queueing
    latency.
    """

    def __init__(self, engine: ServingEngine, batch_size: int = 8,
                 max_delay_ms: float = 50.0):
        self.engine = engine
        self.batch_size = int(batch_size)
        self.max_delay = max_delay_ms / 1000.0
        self._lock = threading.Condition()
        # bucket width -> FIFO of (enqueue time, input array, future)
        self._queues: Dict[int, Deque[Tuple[float, np.ndarray, Future]]] = {}
        self._closing = False
        self._drain = True
        # while spans are kept: future -> (request id, enqueue time on the
        # spans' clock, the submitting thread); and the close's time
        self._traced: Dict[Future, Tuple[int, int, str]] = {}
        self._requests = itertools.count()
        self._close_ns = 0
        self._thread = threading.Thread(target=self._serve_loop,
                                        name="hctr-serving", daemon=True)
        self._thread.start()

    # ---------------------------------------------------------------- API
    def submit(self, image_file: str) -> "Future[str]":
        """Enqueue one image file; resolves to its transcription."""
        return self._enqueue(*self.engine.preprocess_bucketed(image_file))

    def submit_array(self, image: np.ndarray) -> "Future[str]":
        """Enqueue one ``(h, w)`` uint8 grayscale image."""
        return self._enqueue(*self.engine.preprocess_array(image))

    def close(self, drain: bool = True) -> None:
        """Stop the dispatcher; ``drain=True`` serves queued requests
        first, else they are cancelled."""
        with self._lock:
            if profiling.recording():
                self._close_ns = profiling.now_ns()
            self._closing = True
            self._drain = drain
            self._lock.notify()
        self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ----------------------------------------------------------- internals
    def _enqueue(self, w: int, x: np.ndarray) -> "Future[str]":
        fut: Future = Future()
        # read before the deadline's clock, so that a flush that is due on
        # the one is due on the other
        t_ns = profiling.now_ns() if profiling.recording() else 0
        with self._lock:
            if self._closing:
                raise RuntimeError("daemon is shut down")
            self._queues.setdefault(w, deque()).append(
                (time.monotonic(), x, fut))
            if t_ns:
                self._traced[fut] = (next(self._requests), t_ns,
                                     threading.current_thread().name)
            self._lock.notify()
        return fut

    def _pick_flush(self, now: float):
        """Choose a bucket to flush. Deadline-expired heads win, oldest
        first, so a stream of full batches in one bucket cannot starve a
        lone request in another; with no expiry due, any full batch
        flushes."""
        full, expired = None, None
        oldest = None
        for w, q in self._queues.items():
            if not q:
                continue
            head_t = q[0][0]
            if oldest is None or head_t < oldest:
                oldest = head_t
                if now - head_t >= self.max_delay:
                    expired = w
            if full is None and len(q) >= self.batch_size:
                full = w
        return (expired if expired is not None else full), oldest

    def _serve_loop(self) -> None:
        while True:
            with self._lock:
                while True:
                    now = time.monotonic()
                    w, oldest = self._pick_flush(now)
                    if w is not None:
                        q = self._queues[w]
                        n = min(len(q), self.batch_size)
                        items = [q.popleft() for _ in range(n)]
                        traced = ([self._traced.pop(fut, None)
                                   for _, _, fut in items]
                                  if self._traced else [])
                        break
                    if self._closing:
                        pending = [(w, it) for w, q in self._queues.items()
                                   for it in q]
                        for q in self._queues.values():
                            q.clear()
                        if not self._drain:
                            for _, (_, _, fut) in pending:
                                fut.cancel()
                            self._traced.clear()
                            return
                        if not pending:
                            return
                        # drain: -inf timestamps mark every head expired
                        for w, (_, x, fut) in pending:
                            self._queues[w].append((float("-inf"), x, fut))
                        continue
                    timeout = (None if oldest is None
                               else max(0.0, self.max_delay - (now - oldest)))
                    with span("daemon.wait"):
                        self._lock.wait(timeout=timeout)
            with self._flush_span(w, items, traced, now):
                self._dispatch(items)

    def _flush_span(self, w: int, items, traced: list, now: float):
        """The ``daemon.flush`` span of ``items``, popped from bucket ``w``
        at ``now``, and the ``daemon.queue`` span of each request
        (``traced``: their ``_traced`` entries, or empty)."""
        if not profiling.recording():
            return span("daemon.flush")
        popped = profiling.now_ns()
        for req in traced:
            if req is not None:
                profiling.record("daemon.queue", req[1], popped, req[2],
                                 request=req[0], bucket=w)
        head = items[0][0]
        if head == float("-inf"):
            reason, due = "drain", self._close_ns
        elif now - head >= self.max_delay:
            # the head's deadline
            reason = "deadline"
            due = (traced[0][1] + round(self.max_delay * 1e9)
                   if traced and traced[0] else None)
        else:
            # the request that filled the batch
            reason = "full"
            due = traced[-1][1] if traced and traced[-1] else None
        return span("daemon.flush", reason=reason, rows=len(items), bucket=w,
                    due_ns=due, requests=[r[0] for r in traced if r])

    def _dispatch(self, items: List[Tuple[float, np.ndarray, Future]]) -> None:
        pad = self.batch_size - len(items)
        batch = np.concatenate([x for _, x, _ in items]
                               + [items[-1][1]] * pad, axis=0)
        try:
            texts = self.engine.infer_batch(batch)
        except Exception as e:  # noqa: BLE001 - delivered to every waiter
            for _, _, fut in items:
                if not fut.done():
                    fut.set_exception(e)
            return
        for (_, _, fut), text in zip(items, texts):
            if not fut.done():
                fut.set_result(text)
