"""Concurrent serving over ``AggregationSession`` (the port of
``repro/serving/``).

``RouteServer`` (``serving/server.py``) batches concurrent callers'
route requests into one route per flush and runs finalize on snapshots
while ingest continues; ``serving/loadgen.py`` is the open/closed-loop
load generator that writes ``BENCH_torch_serving.json``.
"""
from repro_torch.serving.batching import (
    BackpressureError,
    RequestQueue,
    RouteFuture,
    RouteTimeout,
    ServerClosed,
    ServingError,
)
from repro_torch.serving.server import RouteServer

__all__ = [
    "RouteServer",
    "RouteFuture",
    "RequestQueue",
    "ServingError",
    "BackpressureError",
    "RouteTimeout",
    "ServerClosed",
]
