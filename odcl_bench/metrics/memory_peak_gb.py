"""The card's memory the run holds at its peak, in GB: the CUDA
allocator's peak over the set-up and the window (the federation's
uploads, the session's buffers and a round's temporaries), read once
the window has closed and before the judge runs; nothing from a run off
the card."""


def read(ctx):
    peak = ctx["memory_peak_bytes"]
    return None if peak is None else peak / 1e9
