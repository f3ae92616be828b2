"""The traced run's reading of the device: a ``torch.profiler`` trace of
the first rounds of the window, reduced to the device's busy time,
the device time of each kernel, the top device operations and the idle
gaps by what the host was doing.

The traced rounds run under ``torch.profiler.record_function`` marks
(:func:`mark`: ``odcl_bench.window``, ``.ingest``, ``.finalize``)
so the window and the host's stages lie on the profiler's own clock.
While the trace runs, :func:`record_calls` also notes the shapes of
every call of the program's kernel entry points (``repro_torch.kernels
.ops``), from which the kernels' least times are counted.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict

import torch

from odcl_bench import costs

MARK_PREFIX = "odcl_bench."
WINDOW_MARK = MARK_PREFIX + "window"
TOP = 10


class Shape(tuple):
    """A tensor argument's shape, with ``stored``: the elements the
    tensor stores (a broadcast, stride-0 axis stores one)."""

    def __new__(cls, tensor):
        shape = super().__new__(cls, tuple(tensor.shape))
        shape.stored = costs.radius_elems(tensor)
        return shape


@contextlib.contextmanager
def record_calls(ops_module, names):
    """Note the argument shapes of every call of ``ops_module.<name>`` for
    ``name`` in ``names`` while the block runs: yields ``{name: [(Shape
    of each tensor argument, ...), ...]}``.  The program's modules call
    the entry points through the module, so the wrappers see every call;
    the originals are put back after."""
    calls = {name: [] for name in names}
    originals = {name: getattr(ops_module, name) for name in names}

    def wrap(name, fn):
        def noted(*args, **kwargs):
            calls[name].append(tuple(Shape(a) if hasattr(a, "shape")
                                     else a for a in args))
            return fn(*args, **kwargs)
        return noted

    for name, fn in originals.items():
        setattr(ops_module, name, wrap(name, fn))
    try:
        yield calls
    finally:
        for name, fn in originals.items():
            setattr(ops_module, name, fn)


def profiler(device):
    """A ``torch.profiler`` of the host and, on a card, the device."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def mark(name: str):
    """A ``record_function`` span ``odcl_bench.<name>`` in the trace."""
    from torch.profiler import record_function

    return record_function(MARK_PREFIX + name)


def _merge(intervals):
    """Union of (start, end) intervals, sorted."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def _innermost(host, points):
    """For each time in ``points`` (sorted), the name of the innermost
    host event on the main thread that spans it (``"host code"`` where
    none does): a sweep with a stack of the open events, which nest."""
    out = []
    stack = []
    i = 0
    for t in points:
        while i < len(host) and host[i][0] <= t:
            start, end, name = host[i]
            while stack and stack[-1][0] < start:
                stack.pop()
            stack.append((end, name))
            i += 1
        while stack and stack[-1][0] < t:
            stack.pop()
        out.append(stack[-1][1] if stack else "host code")
    return out


def reduce(prof) -> dict:
    """The traced window's device reading from a finished profile:
    ``window_s``, ``busy_s``, ``kernels`` ({device op name: [durations in
    s]}), ``device_ops`` and ``idle_gaps`` (each the top 10 as [name,
    seconds]).  ``None`` when the trace holds no window mark or no
    device work."""
    from torch.autograd import DeviceType

    device, host, marks = [], [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() * 1e-9
        end = start + e.duration_ns() * 1e-9
        if e.device_type() == DeviceType.CUDA:
            # the marks' device-side copies span kernels, not work
            if not e.name().startswith(MARK_PREFIX):
                device.append((start, end, e.name()))
        elif e.name() == WINDOW_MARK:
            marks.append((start, end, e.start_thread_id()))
        else:
            host.append((start, end, e.name(), e.start_thread_id()))
    if not marks or not device:
        return None
    w0, w1, main = marks[0]
    busy_iv, kernels = [], defaultdict(list)
    for start, end, name in device:
        if end <= w0 or start >= w1:
            continue
        busy_iv.append((max(start, w0), min(end, w1)))
        kernels[name].append(end - start)
    merged = _merge(busy_iv)
    busy = sum(end - start for start, end in merged)
    gaps = [(a[1], b[0]) for a, b in zip([[w0, w0]] + merged,
                                         merged + [[w1, w1]])
            if b[0] > a[1]]
    host_main = sorted((s, e, n) for s, e, n, tid in host
                       if tid == main and s < w1 and e > w0)
    names = _innermost(host_main, [0.5 * (a + b) for a, b in gaps])
    by_host = defaultdict(float)
    for (a, b), name in zip(gaps, names):
        by_host[name] += b - a
    ops = sorted(((n, sum(d)) for n, d in kernels.items()),
                 key=lambda x: -x[1])
    return {"window_s": w1 - w0, "busy_s": busy, "kernels": dict(kernels),
            "device_ops": [[n[:120], s] for n, s in ops[:TOP]],
            "idle_gaps": [[n[:120], s] for n, s in
                          sorted(by_host.items(), key=lambda x: -x[1])[:TOP]]}


def kernel_time(kernels: dict, patterns) -> list:
    """The durations of the device ops whose name holds one of
    ``patterns``."""
    return [d for name, ds in kernels.items()
            if any(p in name for p in patterns) for d in ds]
