"""The rounds' share of the card's roofline: the least time of the work
each round requires for these inputs (``costs.round_work``: the waves'
sketches, the probes' route, and where the round serves the seeding and
Lloyd's least passes or the reference's AMA iterations, and the
per-cluster mean), over the measured time of the rounds that ran
outside the profiler, in %; nothing from a run off the card."""
from odcl_bench import costs


def read(ctx):
    if not ctx["on_gpu"]:
        return None
    first = ctx["traced_rounds"]
    rounds = ctx["rounds"][first:]
    if not rounds:
        return None
    least = sum(costs.least_s(costs.round_work(
        ctx["cfg"], ctx["mix"], count, warm=ctx["warm"],
        ama_iters=ctx["ref"].get("n_iter", 0)))
        for count in ctx["counts"][first:])
    return 100.0 * least / sum(rounds)
