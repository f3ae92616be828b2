"""Dependency-free telemetry core: spans, counters, gauges, histograms.

The port's copy of the parts of ``repro/obs/core.py`` that its engine
uses, so its spans and counters keep the reference's names.  Everything
here is plain stdlib (no torch, no numpy), so the instrumented hot paths
(``core/engine/session.py``, ``core/engine/aggregate.py``) pay a dict
update and a ``perf_counter`` call and nothing else.

  * ``Registry``: counters (monotonic sums), gauges (last-write
    scalars) and histograms (raw-value series with numpy-convention
    percentiles).
  * ``Registry.span(name)``: context manager; on exit the duration
    lands in the ``"<name>.ms"`` histogram.
  * ``Registry.snapshot()``: the aggregates as one dict, which
    ``launch/simulate.py`` returns in its summary.

A process-global registry backs the module-level functions (``span`` /
``count`` / ``gauge`` / ``observe`` / ``snapshot`` / ``reset``), which
is what the engine modules call.
"""
from __future__ import annotations

import contextlib
import math
import threading
import time
from typing import Iterable, Optional


class Histogram:
    """A value series with numpy-default (linear interpolation)
    percentiles: ``percentile(p)`` matches ``numpy.percentile`` on the
    same values."""

    __slots__ = ("values",)

    def __init__(self, values: Optional[Iterable[float]] = None):
        self.values: list[float] = list(values or ())

    def observe(self, value: float) -> None:
        self.values.append(float(value))

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
    """Counters + gauges + histograms.  Mutations are guarded by a lock
    (the engine is single-threaded today, but a serving loop need not
    be)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.histograms: dict[str, Histogram] = {}

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

    @contextlib.contextmanager
    def span(self, name: str):
        """Time a block: its duration lands in ``"<name>.ms"``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(f"{name}.ms", (time.perf_counter() - t0) * 1e3)

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

    def reset(self) -> None:
        """Drop all aggregates."""
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self.histograms.clear()


# ------------------------------------------------- process-global registry

GLOBAL = Registry()


def span(name: str):
    return GLOBAL.span(name)


def count(name: str, value: float = 1.0) -> None:
    GLOBAL.count(name, value)


def gauge(name: str, value: float) -> None:
    GLOBAL.gauge(name, value)


def observe(name: str, value: float) -> None:
    GLOBAL.observe(name, value)


def snapshot() -> dict:
    return GLOBAL.snapshot()


def reset() -> None:
    GLOBAL.reset()
