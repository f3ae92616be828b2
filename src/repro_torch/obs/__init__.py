"""repro_torch.obs: the dependency-free telemetry spine (spans, counters,
gauges, histograms, and pluggable sinks).  See ``obs/core.py``."""
from repro_torch.obs.core import (
    GLOBAL,
    Histogram,
    Registry,
    add_sink,
    close_sinks,
    count,
    event,
    gauge,
    observe,
    remove_sink,
    reset,
    snapshot,
    span,
)
from repro_torch.obs.sinks import ConsoleSink, JsonlSink, ListSink, read_jsonl

__all__ = [
    "GLOBAL",
    "ConsoleSink",
    "Histogram",
    "JsonlSink",
    "ListSink",
    "Registry",
    "add_sink",
    "close_sinks",
    "count",
    "event",
    "gauge",
    "observe",
    "read_jsonl",
    "remove_sink",
    "reset",
    "snapshot",
    "span",
]
