"""Mean Lloyd or AMA iterations a round that served, from each round's
``meta`` ``n_iter``."""


def read(ctx):
    n = ctx["n_iter"]
    return sum(n) / len(n) if n else None
