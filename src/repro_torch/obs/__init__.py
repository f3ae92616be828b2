"""repro_torch.obs: the dependency-free telemetry spine (spans, counters,
gauges, histograms, and pluggable sinks).  See ``obs/core.py``; where
torch imports, spans also reach a recording ``torch.profiler``'s trace
(``obs/bridge.py``)."""
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
    set_host_range,
    snapshot,
    span,
)
from repro_torch.obs.sinks import ConsoleSink, JsonlSink, ListSink, read_jsonl

try:
    from repro_torch.obs.bridge import host_range
except ImportError:         # no torch: spans stay off the profiler's trace
    pass
else:
    set_host_range(host_range)

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
    "set_host_range",
    "snapshot",
    "span",
]
