"""The cost of one ``repro_torch.obs`` span on this host, and where the
profiler bridge's host range lands in a trace.

    python3 scripts/span_cost.py [--spans 100000] [--repeats 5]

Times an empty span of a registry with no sink: without the bridge's
hook, with the hook and no profiler, and with the hook while a
``torch.profiler`` records the host (and, with a card, the host and the
card).  With a card, also profiles one matrix product inside a span and
one inside a ``torch.profiler.record_function`` and reports which names
come out among the device's events: the bridge's range should not, the
user annotation does.  Prints one JSON object.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import (ProfilerActivity, profile,  # noqa: E402
                            record_function)

from repro_torch import obs  # noqa: E402
from repro_torch.obs import bridge  # noqa: E402


def us_per_span(n: int, repeats: int) -> dict:
    """Median and spread of ``repeats`` timings of ``n`` empty spans, in
    µs a span."""
    reg = obs.Registry()
    per = []
    for _ in range(repeats):
        reg.reset()
        t0 = time.perf_counter()
        for _ in range(n):
            with reg.span("cost.probe"):
                pass
        per.append((time.perf_counter() - t0) * 1e6 / n)
    return {"median_us": statistics.median(per), "min_us": min(per),
            "max_us": max(per)}


def profiled(activities, n: int, repeats: int) -> dict:
    """``us_per_span`` while a profiler of ``activities`` records, and
    the span names the trace holds as host events."""
    with profile(activities=activities) as prof:
        out = us_per_span(n, repeats)
    events = prof.profiler.kineto_results.events()
    out["host_events"] = sum(1 for e in events if e.name() == "cost.probe"
                             and e.device_type() == DeviceType.CPU)
    return out


def device_copies() -> dict:
    """The device-side events named after a span and after a
    ``record_function`` that each enclose one matrix product."""
    x = torch.randn(2048, 2048, device="cuda")
    (x @ x).sum().item()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with obs.span("bridge.check"):
            y = x @ x
            torch.cuda.synchronize()
        with record_function("annotation.check"):
            y = y @ x
            torch.cuda.synchronize()
    names = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in ("bridge.check", "annotation.check"):
            names.setdefault(e.name(), []).append(str(e.device_type()))
    return names


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--spans", type=int, default=100_000)
    p.add_argument("--repeats", type=int, default=5)
    args = p.parse_args(argv)
    n, r = args.spans, args.repeats
    out = {"torch": torch.__version__, "python": sys.version.split()[0],
           "card": (torch.cuda.get_device_name(0)
                    if torch.cuda.is_available() else None)}
    obs.set_host_range(None)
    out["no_hook"] = us_per_span(n, r)
    obs.set_host_range(bridge.host_range)
    out["hook_no_profiler"] = us_per_span(n, r)
    out["hook_profiler_cpu"] = profiled([ProfilerActivity.CPU], n, r)
    if torch.cuda.is_available():
        out["hook_profiler_cpu_cuda"] = profiled(
            [ProfilerActivity.CPU, ProfilerActivity.CUDA], n, r)
        out["event_device_types"] = device_copies()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
