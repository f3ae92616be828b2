"""Cross-caller micro-batching primitives for the route server (the
port's copy of ``repro/serving/batching.py``).

``RouteServer`` owns one ``RequestQueue``; concurrent callers ``put``
``_Request``s into it and a single batcher thread pulls coalesced
batches out with ``next_batch`` — the ONE place the ``max_batch`` /
``max_wait_ms`` micro-batching policy lives.  Everything here is plain
stdlib threading (no torch): the queue never touches device state, so
backpressure and timeout behavior are testable without a session.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Optional

from repro_torch import obs


class ServingError(RuntimeError):
    """Base class of every route-server error."""


class BackpressureError(ServingError):
    """The bounded request queue is full (and stayed full for the
    caller's timeout) — shed load upstream instead of queueing."""


class ServerClosed(ServingError):
    """The server is stopped (or stopping) and takes no new requests."""


class RouteTimeout(ServingError):
    """The request's deadline passed before a flush served it."""


class RouteFuture:
    """Single-use result slot a submitted request resolves into.

    Thread-safe: the batcher (or a background finalize worker) calls
    ``set_result`` / ``set_error`` exactly once; any number of callers
    can ``result(timeout=)``.  ``done_at`` records the monotonic
    completion time, which is what lets an open-loop load generator
    compute latencies without a waiter thread per request.
    """

    __slots__ = ("_event", "_result", "_error", "done_at")

    def __init__(self):
        self._event = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None
        self.done_at: Optional[float] = None

    def set_result(self, value) -> None:
        self._result = value
        self.done_at = time.monotonic()
        self._event.set()

    def set_error(self, exc: BaseException) -> None:
        self._error = exc
        self.done_at = time.monotonic()
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        """Block for the result; raises the request's error (including
        ``RouteTimeout`` when the batcher expired it) or, if no
        resolution arrives within ``timeout`` seconds, a caller-side
        ``RouteTimeout``."""
        if not self._event.wait(timeout):
            raise RouteTimeout(
                f"no route result within {timeout}s (request still queued "
                "or in flight)")
        if self._error is not None:
            raise self._error
        return self._result


class _Request:
    """One queued route probe: the host-side sketch row plus its future
    and timing (``deadline`` is absolute monotonic time or None)."""

    __slots__ = ("sketch", "future", "enqueued_at", "deadline")

    def __init__(self, sketch, future: RouteFuture, enqueued_at: float,
                 deadline: Optional[float]):
        self.sketch = sketch
        self.future = future
        self.enqueued_at = enqueued_at
        self.deadline = deadline


class RequestQueue:
    """Bounded FIFO between callers and the batcher thread.

    * ``put`` — appends or applies backpressure: a full queue either
      raises ``BackpressureError`` immediately (``block=False``) or
      blocks until space frees / ``timeout`` passes.  Every time a
      caller finds the queue full, the ``serving.backpressure`` counter
      ticks.
    * ``next_batch`` — blocks until at least one request is queued,
      then coalesces up to ``max_batch`` requests, waiting at most
      ``max_wait_s`` past the HEAD request's enqueue time for stragglers
      (so a lone request is never delayed more than the micro-batching
      window).  Returns ``None`` when the queue is stopped and drained.
    * ``stop`` — wakes everyone; with ``drop=True`` the backlog is
      returned to the caller (to fail fast) instead of being flushed.
    """

    def __init__(self, maxsize: int):
        if maxsize < 1:
            raise ValueError("queue maxsize must be >= 1")
        self.maxsize = int(maxsize)
        self._items: collections.deque = collections.deque()
        self._cond = threading.Condition()
        self._stopping = False

    def __len__(self) -> int:
        with self._cond:
            return len(self._items)

    @property
    def stopping(self) -> bool:
        return self._stopping

    def put(self, req: _Request, *, block: bool = True,
            timeout: Optional[float] = None) -> None:
        with self._cond:
            if self._stopping:
                raise ServerClosed("server is shutting down")
            if len(self._items) >= self.maxsize:
                obs.count("serving.backpressure")
                if not block:
                    raise BackpressureError(
                        f"request queue full ({self.maxsize})")
                deadline = (None if timeout is None
                            else time.monotonic() + timeout)
                while len(self._items) >= self.maxsize:
                    if self._stopping:
                        raise ServerClosed("server is shutting down")
                    remaining = (None if deadline is None
                                 else deadline - time.monotonic())
                    if remaining is not None and remaining <= 0:
                        raise BackpressureError(
                            f"request queue full ({self.maxsize}) for "
                            f"{timeout}s")
                    self._cond.wait(remaining)
            self._items.append(req)
            depth = float(len(self._items))
            obs.gauge("serving.queue_depth", depth)
            obs.observe("serving.queue_depth", depth)
            self._cond.notify_all()

    def next_batch(self, max_batch: int,
                   max_wait_s: float) -> Optional[list]:
        with self._cond:
            while not self._items:
                if self._stopping:
                    return None
                self._cond.wait()
            flush_by = self._items[0].enqueued_at + max_wait_s
            batch = [self._items.popleft()]
            while len(batch) < max_batch:
                if self._items:
                    batch.append(self._items.popleft())
                    continue
                if self._stopping:
                    break          # drain fast: flush what we hold
                remaining = flush_by - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
                if not self._items and time.monotonic() >= flush_by:
                    break
            self._cond.notify_all()    # space freed: wake blocked putters
            return batch

    def stop(self, *, drop: bool = False) -> list:
        with self._cond:
            self._stopping = True
            dropped: list = []
            if drop:
                dropped = list(self._items)
                self._items.clear()
            self._cond.notify_all()
            return dropped
