"""The work of one call of each hand-written kernel, from its shapes:
``(bytes, ops)``, the one home of these counts.

Bytes count each input read once and each output written once (fp32
unless stated); ops count the arithmetic the function needs, whatever
the kernel repeats.  ``chip_smoke.py`` phase 5 divides them by the
card's peaks for each kernel's bound; ``kernels/ops.py`` charges them at
every dispatch, whichever implementation runs (the kernel on the card,
the plain version on the CPU), to the open :func:`tally` of the calling
thread, which is how the engine's programs count their work
(``core/engine/aggregate.py``); ``roofline/engine_costs.py`` probes the
kernels with them.
"""
from __future__ import annotations

import contextlib
import math
import threading

F32 = 4


def pairwise_sqdist(m: int, k: int, d: int, batches: int = 1) -> tuple:
    """(m, d) x (k, d) -> (m, k) squared distances by the expansion:
    2mkd for the products, 2(m + k)d for the norms, 3mk to combine and
    clamp; ``batches`` windows of that shape."""
    nbytes = F32 * (m * d + k * d + m * k)
    ops = 2.0 * m * k * d + 2.0 * (m + k) * d + 3.0 * m * k
    return batches * nbytes, batches * ops


def kmeans_assign(m: int, k: int, d: int) -> tuple:
    """(m, d) points x (k, d) centers -> labels (m,) int32, sums (k, d)
    and counts (k,): the distances as ``pairwise_sqdist`` computes them
    without the (m, k) matrix, plus md adds for the sums."""
    nbytes = F32 * (m * d + k * d) + F32 * m + F32 * (k * d + k)
    ops = 2.0 * m * k * d + 2.0 * m * d + 3.0 * m * k + m * d
    return nbytes, ops


def group_ball_proj(rows: int, d: int, radius_elems: int) -> tuple:
    """Each of ``rows`` rows of width d (over every rung) projected onto
    its ball: the rows read and written, ``radius_elems`` fp32 radii
    read; 3d + 3 ops a row (the squared norm, the scale, the compare)."""
    return (2.0 * F32 * rows * d + F32 * radius_elems,
            (3.0 * d + 3) * rows)


def ama_step(b: int, e: int, m: int, d: int, radius_elems: int) -> tuple:
    """One fused AMA edge pass over b rungs of e edges: the prox of the
    (b, e, d) stepped dual, plus u (b, m, d) and the two int32 edge ends
    read, the step's max written; 5d more ops a row (the edge difference,
    the step, the subtraction, |new - nu| and its max)."""
    nbytes, ops = group_ball_proj(b * e, d, radius_elems)
    return (nbytes + F32 * (b * m * d + 2 * e + 1), ops + 5.0 * d * b * e)


def ama_gather_back(b: int, e: int, m: int, d: int) -> tuple:
    """u (b, m, d) = a (m, d) + head sums - tail sums of the (b, e, d)
    dual: the dual and a read once, u written once; 2 adds a dual value
    (into its head's sum and its tail's) and 2 ops a value of u.  The
    kernel reads the dual twice (heads, then tails), so it can reach at
    most half of this bound."""
    return (F32 * (b * e * d + m * d + b * m * d),
            2.0 * b * e * d + 2.0 * b * m * d)


def radius_elems(radius) -> int:
    """Radii a prox call reads: one for a Python number, else the
    tensor's elements that are stored (a broadcast, stride-0 axis reads
    one)."""
    if not hasattr(radius, "stride"):
        return 1
    return math.prod(n for n, st in zip(radius.shape, radius.stride())
                     if st != 0)


def _ramp_sum(lo: int, hi: int, cap: float) -> int:
    """sum of min(max(x, 0), cap) over the integers x in [lo, hi)."""
    def prefix(n):                  # the sum over x in [0, n)
        if n <= 0:
            return 0
        if n <= cap + 1:
            return n * (n - 1) // 2
        cap_i = int(cap)
        return cap_i * (cap_i + 1) // 2 + (n - cap_i - 1) * cap_i
    return prefix(hi) - prefix(lo) if hi > lo else 0


def flash_live_pairs(sq: int, skv: int, causal: bool,
                     window: int | None) -> int:
    """Live (query, key) pairs of one head: query i sits at position
    p = i + skv - sq and sees the keys j < skv with j <= p (causal) and
    j > p - window (a window).  Closed form over the positions."""
    first = skv - sq                      # the first query's position
    if causal:
        # min(p + 1, window) keys at p >= 0, none before
        return _ramp_sum(first + 1, first + 1 + sq,
                         window if window is not None else math.inf)
    if window is None:
        return sq * skv
    # skv - max(0, p - window + 1) keys
    return sq * skv - _ramp_sum(first - window + 1,
                                first - window + 1 + sq, math.inf)


def flash_attention(b: int, h: int, hkv: int, sq: int, skv: int, dh: int,
                    *, causal: bool, window: int | None,
                    itemsize: int) -> tuple:
    """Attention of b x h query heads over hkv key heads: q and o
    (b, h, sq, dh) and k and v (b, hkv, skv, dh) moved once at
    ``itemsize`` bytes; 4 dh ops for each live pair (QK^T and PV).  The
    softmax's exponentials are not counted."""
    live = flash_live_pairs(sq, skv, causal, window)
    nbytes = itemsize * (2 * b * h * sq * dh + 2 * b * hkv * skv * dh)
    return float(nbytes), 4.0 * b * h * dh * live


class Work:
    """Bytes and ops charged while a :func:`tally` is open."""

    __slots__ = ("bytes", "ops")

    def __init__(self):
        self.bytes = 0.0
        self.ops = 0.0


_LOCAL = threading.local()


@contextlib.contextmanager
def tally():
    """Collect the work of every kernel call this thread makes in the
    block (nested tallies each collect it).  Yields a :class:`Work`."""
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    work = Work()
    stack.append(work)
    try:
        yield work
    finally:
        stack.pop()


def charge(cost: tuple) -> None:
    """Add one call's ``(bytes, ops)`` to this thread's open tallies."""
    nbytes, ops = cost
    for work in getattr(_LOCAL, "stack", ()):
        work.bytes += nbytes
        work.ops += ops
