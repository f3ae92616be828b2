"""The sliding window's eviction, a round's mean: the sum of
``session.evict.ms`` (``repro_torch.obs``; every
``AggregationSession.evict_stale``, after each ingest and before each
snapshot) over the rounds run outside the profiler."""


def read(ctx):
    n = len(ctx["rounds"]) - ctx["traced_rounds"]
    values = ctx["spans"].get("session.evict.ms")
    return sum(values) / n if values and n > 0 else None
