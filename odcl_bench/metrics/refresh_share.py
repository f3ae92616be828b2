"""The share of the window's rounds, in %, in which the drift gauge
tripped the warm refinalize (``maybe_refinalize`` returned a round; the
others keep serving the round before)."""


def read(ctx):
    if not ctx["warm"]:
        return None
    return 100.0 * sum(1 for c in ctx["counts"] if c) / len(ctx["counts"])
