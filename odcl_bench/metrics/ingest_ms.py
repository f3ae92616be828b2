"""p50 of the benchmark's own span around a round's
``AggregationSession.ingest`` calls, ended by a synchronize (session
layer), over the rounds run outside the profiler."""
from odcl_bench.harness import percentile


def read(ctx):
    values = ctx["ingest_s"][ctx["traced_rounds"]:]
    return 1e3 * percentile(values, 50.0) if values else None
