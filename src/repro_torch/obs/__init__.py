"""repro_torch.obs: the dependency-free telemetry spine (spans, counters,
gauges, histograms).  See ``obs/core.py``."""
from repro_torch.obs.core import (
    GLOBAL,
    Histogram,
    Registry,
    count,
    gauge,
    observe,
    reset,
    snapshot,
    span,
)

__all__ = [
    "GLOBAL",
    "Histogram",
    "Registry",
    "count",
    "gauge",
    "observe",
    "reset",
    "snapshot",
    "span",
]
