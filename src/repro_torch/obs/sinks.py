"""Sinks for the telemetry registry (the port's copy of
``repro/obs/sinks.py``).  A sink is anything with ``emit(event: dict)``
and, optionally, ``close()``; attach it with ``obs.add_sink``:

  * ``JsonlSink``: every event as one JSON line (``simulate --trace
    PATH``); ``read_jsonl`` parses a trace back.
  * ``ConsoleSink``: silent during the run, prints the registry's
    aggregate table on ``close()``.
  * ``ListSink``: in-memory capture (tests, ad-hoc inspection).
"""
from __future__ import annotations

import json
import sys
from typing import Any


def _jsonable(value: Any):
    """Events may carry tensor or numpy scalars: plain JSON types."""
    try:
        json.dumps(value)
        return value
    except TypeError:
        item = getattr(value, "item", None)
        return item() if callable(item) else repr(value)


class JsonlSink:
    """Append events as JSON lines (line-buffered, so a crash keeps every
    line written before it)."""

    def __init__(self, path: str, mode: str = "a"):
        self.path = path
        self._f = open(path, mode, buffering=1)

    def emit(self, event: dict) -> None:
        self._f.write(json.dumps({k: _jsonable(v) for k, v in event.items()})
                      + "\n")

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


def read_jsonl(path: str) -> list[dict]:
    """Parse a JSONL trace back into a list of event dicts."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


class ListSink:
    """In-memory event capture."""

    def __init__(self):
        self.events: list[dict] = []

    def emit(self, event: dict) -> None:
        self.events.append(event)

    def close(self) -> None:
        pass


class ConsoleSink:
    """Print an aggregate summary table when closed, from its registry
    (the process-global one by default), read at ``close()``."""

    def __init__(self, registry=None, stream=None):
        self._registry = registry
        self._stream = stream or sys.stderr
        self._events = 0

    def emit(self, event: dict) -> None:
        self._events += 1

    def close(self) -> None:
        from repro_torch.obs import core

        reg = self._registry if self._registry is not None else core.GLOBAL
        snap = reg.snapshot()
        w = self._stream.write
        w(f"[obs] {self._events} events\n")
        for name in sorted(snap["counters"]):
            w(f"[obs] counter {name} = {snap['counters'][name]:g}\n")
        for name in sorted(snap["gauges"]):
            w(f"[obs] gauge   {name} = {snap['gauges'][name]:g}\n")
        for name in sorted(snap["histograms"]):
            h = snap["histograms"][name]
            if not h.get("count"):
                continue
            w(f"[obs] hist    {name}: n={h['count']} p50={h['p50']:.3g} "
              f"p95={h['p95']:.3g} p99={h['p99']:.3g} max={h['max']:.3g}\n")
