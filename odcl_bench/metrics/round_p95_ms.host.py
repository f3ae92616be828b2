"""The 95th percentile of the times of the traced run's rounds that ran
outside the profiler.  Kept per-layer: the host paces these rounds, and
repeated runs of one seed spread too widely for a bound (``PERF.md``)."""
from odcl_bench.harness import percentile


def read(ctx):
    rounds = ctx["rounds"][ctx["traced_rounds"]:]
    return 1e3 * percentile(rounds, 95.0) if rounds else None
