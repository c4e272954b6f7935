"""Continuous serving daemon: a deadline-batched request queue per bucket
(the JAX package's ``serve/daemon.py``).

Requests arrive one at a time; the daemon accumulates them per width bucket
and flushes a bucket when a full batch has formed or its oldest request has
waited ``max_delay_ms``. Results are delivered through per-request futures
and equal what ``ServingEngine.infer_files`` returns for the same image.

Threading model: callers preprocess on their own thread (``submit``), and a
single dispatcher thread owns the device.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Deque, Dict, List, Tuple

import numpy as np

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
        with self._lock:
            if self._closing:
                raise RuntimeError("daemon is shut down")
            self._queues.setdefault(w, deque()).append(
                (time.monotonic(), x, fut))
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
                        break
                    if self._closing:
                        pending = [(w, it) for w, q in self._queues.items()
                                   for it in q]
                        for q in self._queues.values():
                            q.clear()
                        if not self._drain:
                            for _, (_, _, fut) in pending:
                                fut.cancel()
                            return
                        if not pending:
                            return
                        # drain: -inf timestamps mark every head expired
                        for w, (_, x, fut) in pending:
                            self._queues[w].append((float("-inf"), x, fut))
                        continue
                    timeout = (None if oldest is None
                               else max(0.0, self.max_delay - (now - oldest)))
                    self._lock.wait(timeout=timeout)
            self._dispatch(items)

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
