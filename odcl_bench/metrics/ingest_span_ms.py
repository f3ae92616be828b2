"""The program's own time in the session's ingest, a round's mean: the
sum of ``session.ingest.ms`` (``repro_torch.obs``; the whole
``AggregationSession.ingest`` call, slot table, device write and
eviction) over the rounds run outside the profiler.  The inside twin of
``ingest_ms.km``, which times the same calls from the benchmark.  Read
only where the span has its children (``session.ingest.assign``): a
program whose ``session.ingest`` times the device write alone gives
nothing."""


def read(ctx):
    n = len(ctx["rounds"]) - ctx["traced_rounds"]
    values = ctx["spans"].get("session.ingest.ms")
    if not values or not ctx["spans"].get("session.ingest.assign.ms") \
            or n <= 0:
        return None
    return sum(values) / n
