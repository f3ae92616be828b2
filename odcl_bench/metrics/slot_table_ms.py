"""The host's keyed slot table in the session's ingest, a round's mean:
the sums of ``session.ingest.assign.ms`` (the wave's ids looked up and
rows taken) and ``session.ingest.commit.ms`` (the slot table, stamps and
free list written back) in ``repro_torch.obs``, over the rounds run
outside the profiler.  Eviction is ``evict_ms``."""


def read(ctx):
    n = len(ctx["rounds"]) - ctx["traced_rounds"]
    assign = ctx["spans"].get("session.ingest.assign.ms")
    commit = ctx["spans"].get("session.ingest.commit.ms")
    if not (assign and commit) or n <= 0:
        return None
    return (sum(assign) + sum(commit)) / n
