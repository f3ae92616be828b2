"""``clients_per_s`` of the rounds that ran outside the profiler: live
clients clustered and averaged, summed over those rounds, over their
seconds.  Per-layer in the cells the host paces, whose runs spread too
widely for a bound on the rate (``PERF.md``)."""


def read(ctx):
    first = ctx["traced_rounds"]
    rounds = ctx["rounds"][first:]
    return sum(ctx["counts"][first:]) / sum(rounds) if rounds else None
