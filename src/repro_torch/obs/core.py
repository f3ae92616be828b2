"""Dependency-free telemetry core: spans, counters, gauges, histograms.

The port's copy of ``repro/obs/core.py``, so its spans and counters keep
the reference's names.
Everything here is plain stdlib (no torch, no numpy), so the
instrumented hot paths (``core/engine/session.py``,
``core/engine/aggregate.py``) pay a dict update and a ``perf_counter``
call and nothing else.

  * ``Registry``: counters (monotonic sums), gauges (last-write
    scalars) and histograms (raw-value series with numpy-convention
    percentiles), plus a thread-local span stack for nested timing.
  * ``Registry.span(name, **fields)``: context manager; on exit the
    duration lands in the ``"<name>.ms"`` histogram and a ``"span"``
    event (its fields, ``parent``/``depth`` from the nesting stack and
    ``ms``) goes to every attached sink.  The yielded dict carries the
    measured ``ms`` after the block.
  * sinks (``obs/sinks.py``): anything with ``emit(event: dict)``;
    ``JsonlSink`` appends events as JSON lines (``simulate --trace``).
  * ``Registry.snapshot()``: the aggregates as one dict, which
    ``launch/simulate.py`` returns in its summary.
  * a host-range hook (``set_host_range``): where torch is present,
    ``obs/bridge.py`` installs one, and every span then also opens a
    host range of its name while a ``torch.profiler`` records, so the
    trace's host timeline is named by the program's spans.  Without a
    recording profiler a span pays one flag read more.

A process-global registry backs the module-level functions (``span`` /
``count`` / ``gauge`` / ``observe`` / ``event`` / ``snapshot`` /
``reset`` / ``add_sink``), which is what the engine modules call.
"""
from __future__ import annotations

import contextlib
import math
import threading
import time
from typing import Any, Callable, Iterable, Optional


class Histogram:
    """A value series with numpy-default (linear interpolation)
    percentiles: ``percentile(p)`` matches ``numpy.percentile`` on the
    same values."""

    __slots__ = ("values",)

    def __init__(self, values: Optional[Iterable[float]] = None):
        self.values: list[float] = list(values or ())

    def observe(self, value: float) -> None:
        self.values.append(float(value))

    def merge(self, other: "Histogram") -> None:
        """Pool ``other``'s values into this series."""
        self.values.extend(other.values)

    @property
    def count(self) -> int:
        return len(self.values)

    def percentile(self, p: float) -> float:
        if not self.values:
            return float("nan")
        vals = sorted(self.values)
        rank = (p / 100.0) * (len(vals) - 1)
        lo = math.floor(rank)
        hi = math.ceil(rank)
        if lo == hi:
            return vals[lo]
        frac = rank - lo
        return vals[lo] * (1.0 - frac) + vals[hi] * frac

    def summary(self) -> dict:
        if not self.values:
            return {"count": 0}
        total = sum(self.values)
        return {
            "count": len(self.values),
            "sum": total,
            "mean": total / len(self.values),
            "min": min(self.values),
            "max": max(self.values),
            "p50": self.percentile(50.0),
            "p95": self.percentile(95.0),
            "p99": self.percentile(99.0),
        }


class Registry:
    """Counters + gauges + histograms + sinks + a span stack.  Mutations
    are guarded by a lock (the route server's threads share the global
    registry); the span stack is per thread.  ``reset()`` clears the
    aggregates and keeps the attached sinks."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.histograms: dict[str, Histogram] = {}
        self._sinks: list[Any] = []

    # ----------------------------------------------------------- metrics

    def count(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0.0) + float(value)

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            hist = self.histograms.get(name)
            if hist is None:
                hist = self.histograms[name] = Histogram()
            hist.observe(value)

    # ------------------------------------------------------------- spans

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    @contextlib.contextmanager
    def span(self, name: str, **fields: Any):
        """Time a block: its duration lands in ``"<name>.ms"`` and a
        ``"span"`` event with ``fields`` and the nesting (``parent``,
        ``depth``) goes to the sinks.  The yielded dict gains ``"ms"``."""
        stack = self._stack()
        info = {"name": name, **fields}
        if stack:
            info["parent"] = stack[-1]
        info["depth"] = len(stack)
        stack.append(name)
        host_range = _host_range(name) if _host_range is not None else None
        t0 = time.perf_counter()
        try:
            yield info
        finally:
            ms = (time.perf_counter() - t0) * 1e3
            if host_range is not None:
                host_range.__exit__(None, None, None)
            stack.pop()
            info["ms"] = ms
            self.observe(f"{name}.ms", ms)
            self.event("span", **info)

    # ------------------------------------------------------------- sinks

    def add_sink(self, sink: Any) -> Any:
        """Attach anything with ``emit(event: dict)`` (and optionally
        ``close()``).  Returns the sink."""
        with self._lock:
            self._sinks.append(sink)
        return sink

    def remove_sink(self, sink: Any) -> None:
        with self._lock:
            if sink in self._sinks:
                self._sinks.remove(sink)

    def event(self, kind: str, **fields: Any) -> dict:
        """Emit one structured event to every sink.  Returns the event."""
        evt = {"event": kind, "ts": time.time(), **fields}
        with self._lock:
            sinks = list(self._sinks)
        for sink in sinks:
            sink.emit(evt)
        return evt

    def close_sinks(self) -> None:
        """Detach every sink and close those that can be closed."""
        with self._lock:
            sinks, self._sinks = list(self._sinks), []
        for sink in sinks:
            close = getattr(sink, "close", None)
            if callable(close):
                close()

    # ---------------------------------------------------------- snapshot

    def snapshot(self) -> dict:
        """The aggregates as one dict."""
        with self._lock:
            return {
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "histograms": {n: h.summary()
                               for n, h in self.histograms.items()},
            }

    def merge(self, other: "Registry") -> None:
        """Fold another registry's aggregates in: counters sum, gauges take
        ``other``'s value (the last write), histogram values are pooled.
        Counter sums and histogram value multisets do not depend on the
        order of merges.  ``other`` is copied under its own lock first,
        then folded in under this one's (never both at once)."""
        with other._lock:
            counters = dict(other.counters)
            gauges = dict(other.gauges)
            values = {n: list(h.values) for n, h in other.histograms.items()}
        with self._lock:
            for name, v in counters.items():
                self.counters[name] = self.counters.get(name, 0.0) + v
            self.gauges.update(gauges)
            for name, vals in values.items():
                self.histograms.setdefault(name, Histogram()).values.extend(
                    vals)

    def reset(self) -> None:
        """Drop all aggregates; attached sinks stay attached."""
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self.histograms.clear()


# ------------------------------------------------------ host-range hook

# ``hook(name)`` opens a host range named ``name`` and returns it (it is
# closed with ``__exit__``), or returns ``None``; ``None`` where no hook
# is installed
_host_range: Optional[Callable[[str], Any]] = None


def set_host_range(hook: Optional[Callable[[str], Any]]) -> None:
    """Install the hook every span calls as it opens (``None``: none)."""
    global _host_range
    _host_range = hook


# ------------------------------------------------- process-global registry

GLOBAL = Registry()


def span(name: str, **fields: Any):
    return GLOBAL.span(name, **fields)


def count(name: str, value: float = 1.0) -> None:
    GLOBAL.count(name, value)


def gauge(name: str, value: float) -> None:
    GLOBAL.gauge(name, value)


def observe(name: str, value: float) -> None:
    GLOBAL.observe(name, value)


def event(kind: str, **fields: Any) -> dict:
    return GLOBAL.event(kind, **fields)


def add_sink(sink: Any) -> Any:
    return GLOBAL.add_sink(sink)


def remove_sink(sink: Any) -> None:
    GLOBAL.remove_sink(sink)


def close_sinks() -> None:
    GLOBAL.close_sinks()


def snapshot() -> dict:
    return GLOBAL.snapshot()


def reset() -> None:
    GLOBAL.reset()
