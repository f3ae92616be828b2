"""What the per-layer readers share: a kernel's roofline share."""
from __future__ import annotations

from odcl_bench import costs, trace


def roofline(ctx, entries, kernels, cost):
    """A kernel's share of its roofline, in %: the mean least time of the
    calls of its entry points ``entries`` (``cost(shapes) -> (bytes,
    ops)``), times the kernel launches the trace holds (names containing
    one of ``kernels``), over their device time.  ``None`` without a
    trace or a launch."""
    tr, calls = ctx["trace"], ctx["calls"]
    if tr is None or calls is None:
        return None
    shapes = [args for name in entries for args in calls.get(name, ())]
    times = trace.kernel_time(tr["kernels"], kernels)
    if not shapes or not times:
        return None
    least = sum(costs.least_s(cost(args)) for args in shapes) / len(shapes)
    return 100.0 * least * len(times) / sum(times)
