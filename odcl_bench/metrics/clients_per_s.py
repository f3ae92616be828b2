"""Live clients clustered and averaged, summed over every round of the
window (a round that serves nothing new adds none), over the window's
seconds."""


def read(ctx):
    return sum(ctx["counts"]) / ctx["window_s"]
