"""The benchmark's harness: one run of one cell.

``BENCHMARK.json`` names the cell; its configuration is
``odcl_bench/configs/<config>.json`` (the deployment's sizes and the
judge's limits), its traffic ``odcl_bench/traffic/<traffic>.json`` (the
round loop's parameters) and each metric ``odcl_bench/metrics/<name>.py``
(a ``read(ctx)`` that returns the number or ``None``).  Nothing here
names a cell, a configuration, a mix or a metric.

A run: the uploads are made on the device from ``--seed``
(``inputs.py``), the federation is ingested into one
``AggregationSession``, one round warms the cell's shapes,
then the window is a closed loop of server rounds, one at a time: round
g ingests its keyed waves (a re-upload, and the joiners) and runs
``finalize()``, or routes never-seen probes and runs
``maybe_refinalize()``; it is timed from the start of its ingest to the
end of the round's stream synchronize.  The window closes at the end of
the round that crosses ``--seconds`` (of the next round that serves,
where that one did not).  With ``--trace 1`` the first rounds run under
``torch.profiler`` (``trace.py``).  Then the peak memory is read, the
session is freed, and the served round's outputs are judged against the
plain reference (``judge.py``).
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from odcl_bench import inputs, judge, trace

ROOT = Path(__file__).resolve().parents[1]
# the reference package, its dependencies and its top-level name, which
# the port's (``repro_torch``) begins with: compared whole
BANNED = ("jax", "jaxlib", "flax", "repro")
# the traced rounds: those that start within this many seconds of the
# window's start (or its first half), and at least two
TRACE_SECONDS = 5.0
# rounds past the window's seconds that wait for a round that serves
STALE_ROUNDS = 8
KERNEL_ENTRIES = ("pairwise_sqdist", "kmeans_assign", "group_ball_proj",
                  "group_ball_proj_batched")


def process_start() -> float:
    """This process's start on the epoch clock, from ``/proc``."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        boot = next(int(line.split()[1]) for line in f
                    if line.startswith("btime"))
    return boot + ticks / os.sysconf("SC_CLK_TCK")


def banned_modules() -> list:
    """Loaded modules whose top-level name is a banned one."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(BANNED))


def load_bench(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def resolve(bench: dict, workload: str, root: Path = ROOT) -> tuple:
    """``(cell, configuration, mix)``: the cell's entry, its configuration
    file and its traffic file, each found by name."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no cell {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(root / entry["file"]) as f:
        cfg = json.load(f)
    traffic = root / "odcl_bench" / "traffic" / f"{cell['traffic']}.json"
    with open(traffic) as f:
        mix = json.load(f)
    return cell, cfg, mix


def metric_entries(bench: dict, workload: str, traced: bool) -> list:
    """The metrics this cell reports in a run: its end-to-end metrics, or
    with the trace its per-layer ones."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def reader(name: str, root: Path = ROOT):
    """``odcl_bench/metrics/<name>.py``, loaded from its file."""
    path = root / "odcl_bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"odcl_bench.metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def import_program(root: Path = ROOT):
    """The system under test, ``repro_torch``, from the checkout's
    ``src``: refused when it is not there."""
    src = (root / "src").resolve()
    if not (src / "repro_torch").is_dir():
        raise RuntimeError(f"the program is not in this checkout ({src})")
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    import repro_torch
    from repro_torch import obs
    from repro_torch.core.engine.session import AggregationSession
    from repro_torch.kernels import ops

    where = Path(repro_torch.__file__).resolve()
    if src not in where.parents:
        raise RuntimeError(f"repro_torch was imported from {where}, not {src}")
    return AggregationSession, obs, ops


def recovery_lambda(up: inputs.Uploads) -> float:
    """The paper's E.1 penalty: the midpoint of the recovery interval
    (17) of the planted partition of the models, the interval met by
    every wave the window serves; where it is empty, its lower end (as
    the program's ``simulate`` takes it)."""
    spans = [inputs.lambda_interval(w, up.labels.cpu().numpy())
             for entry in up.pool for w in entry]
    lo, hi = max(s[0] for s in spans), min(s[1] for s in spans)
    return 0.5 * (lo + hi) if lo < hi else lo


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Loop:
    """One cell's federation and its round loop.  A mix's ``round`` is
    ``finalize`` (a cold round, its clustering drawn from its own seed)
    or ``maybe_refinalize`` (the never-seen ``probes`` routed, then the
    warm refinalize where the drift gauge passes ``threshold``)."""

    def __init__(self, session_cls, cfg: dict, mix: dict, seed: int, device):
        self.seed, self.device = seed, device
        self.up = inputs.Uploads(cfg, mix, seed, device)
        opts = dict(cfg["algo_options"])
        self.lam = None
        if cfg.get("lambda") == "recovery":
            self.lam = recovery_lambda(self.up)
            opts["lam"] = self.lam
        self.args = dict(algorithm=cfg["algorithm"], k=cfg["clusters"],
                         algo_options=opts, aggregator=cfg["aggregator"])
        self.mode, self.threshold = mix["round"], mix.get("threshold")
        if self.mode not in ("finalize", "maybe_refinalize"):
            raise ValueError(f"unknown round {self.mode!r}")
        if self.mode == "maybe_refinalize" and not self.up.probes:
            raise ValueError("a drift-triggered round needs probes")
        self.warm = self.mode == "maybe_refinalize"
        staleness = ("none" if self.up.max_age is None
                     else f"max_age={self.up.max_age}")
        self.session = session_cls(
            self.up.capacity, sketch_dim=cfg["sketch_dim"],
            seed=inputs.subseed(seed, 3), staleness=staleness,
            projection=self.up.projection, device=device)
        self.g, self.last, self.centers = -1, None, {}

    def fill(self) -> None:
        """Set-up: every client's first upload; a drift-triggered mix
        also serves one cold round, which the window's rounds start
        from."""
        w = self.up.wave
        for b, models in enumerate(self.up.init):
            self.session.ingest({"theta": models},
                                client_ids=range(b * w, (b + 1) * w))
        if self.warm:
            self.session.cluster_seed = inputs.subseed(self.seed,
                                                       (1 << 32) - 1)
            self.last = (self.g, self.session.finalize(**self.args))
        _sync(self.device)

    def round(self, g: int, mark=None) -> tuple:
        """Round g: ``(ingest s, round s, info)``, ``info`` ``None`` where
        the round served nothing new."""
        mark = mark or (lambda name: contextlib.nullcontext())
        t0 = time.perf_counter()
        with mark("ingest"):
            for ids, models in self.up.round_waves(g):
                self.session.ingest({"theta": models}, client_ids=ids)
            _sync(self.device)
        t1 = time.perf_counter()
        with mark("finalize"):
            if self.warm:
                self.session.route(self.session.sketch_params(
                    {"theta": self.up.probe_wave(g)}))
                out = self.session.maybe_refinalize(self.threshold)
            else:
                self.session.cluster_seed = inputs.subseed(self.seed,
                                                           (1 << 32) + g)
                out = self.session.finalize(**self.args)
            _sync(self.device)
        t2 = time.perf_counter()
        self.g = g
        if out is not None:
            self.last = (g, out)
            self.centers[g] = self.session.route_centers
        return t1 - t0, t2 - t0, None if out is None else out[2]

    def outputs(self) -> dict:
        """The served round's outputs, as the judge reads them: ``round``
        (the round it served), ``last`` (the last round run), ``ids``
        (the live clients in the session's row order, from its slot
        table) and the rows and models it hands back."""
        g, (state, labels, info) = self.last
        slots = self.session.clients
        ids = np.fromiter(slots.keys(), np.int64, len(slots))
        rows = np.fromiter(slots.values(), np.int64, len(slots))
        return {"round": g, "last": self.g, "warm": self.warm and g >= 0,
                "ids": ids[np.argsort(rows)],
                "sketches": self.session.sketches,
                "labels": torch.as_tensor(labels),
                "centers": self.session.route_centers,
                "models": self.session.cluster_models()["theta"],
                "client_models": state.params["theta"]}


class Window:
    """The window's rounds and what each one reported.  It closes at the
    end of the round that crosses its seconds, or, where that round
    served nothing new, of the first later one that does (at most
    ``STALE_ROUNDS`` more)."""

    def __init__(self, loop: Loop):
        self.loop = loop
        self.rounds, self.ingests, self.n_iter, self.counts = [], [], [], []

    def step(self, mark=None) -> None:
        ingest_s, round_s, info = self.loop.round(self.loop.g + 1, mark)
        self.rounds.append(round_s)
        self.ingests.append(ingest_s)
        self.counts.append(0 if info is None else info["count"])
        if info is not None:
            self.n_iter.append(info["meta"]["n_iter"])

    def run(self, seconds: float, t0: float) -> None:
        """Rounds until the window closes (``t0`` its start), at least
        one."""
        past, start = 0, len(self.rounds)
        while True:
            if len(self.rounds) > start and \
                    time.perf_counter() - t0 >= seconds:
                if self.loop.last[0] == self.loop.g or past >= STALE_ROUNDS:
                    return
                past += 1
            self.step()


def _stage(warm: bool) -> str:
    """The span prefix of the round's stages in ``repro_torch.obs``."""
    return "session.refinalize" if warm else "session.finalize"


def set_up(loop: Loop) -> None:
    """The federation filled and one round run, after which the live
    window holds its steady count and every shape is warm."""
    loop.fill()
    loop.round(0)


def judge_loop(loop: Loop, cfg: dict, window_rounds: list) -> tuple:
    """``(values, ref)``: the served round judged against the reference,
    with the program's state freed first; for a cold mix also the
    seeding's quality over a sample of ``window_rounds`` drawn from the
    run's seed."""
    out = loop.outputs()
    centers = {g: loop.centers[g] for g in window_rounds
               if g in loop.centers}
    loop.session = loop.last = None
    loop.centers = {}
    gc.collect()
    if torch.device(loop.device).type == "cuda":
        torch.cuda.empty_cache()
    values, ref = judge.compare(cfg, out, loop.up, loop.lam)
    del out
    if not loop.warm:
        values.update(judge.seeding(
            cfg, loop.up, centers, inputs.generator(loop.seed, 8,
                                                    loop.device)))
    return values, ref


def run(workload: str, seed: int, seconds: float, traced: bool, *,
        device="cuda", root: Path = ROOT,
        t_start: float | None = None) -> dict:
    """One run of a cell: returns the result line's object.  ``t_start``
    is the process's start on the epoch clock (the call's, without
    it)."""
    t_start = time.time() if t_start is None else t_start
    parts = {"torch": time.time() - t_start}
    bench = load_bench(root)
    cell, cfg, mix = resolve(bench, workload, root)
    session_cls, obs, ops = import_program(root)
    parts["program"] = time.time() - t_start
    loop = Loop(session_cls, cfg, mix, seed, device)
    _sync(device)
    parts["uploads"] = time.time() - t_start
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    set_up(loop)
    obs.reset()
    setup_s = parts["set_up"] = time.time() - t_start

    win = Window(loop)
    first = loop.g + 1
    prof = calls = None
    with contextlib.ExitStack() as tracing:
        if traced:
            calls = tracing.enter_context(trace.record_calls(ops,
                                                             KERNEL_ENTRIES))
            prof = tracing.enter_context(trace.profiler(device))
        t0 = time.perf_counter()        # after the tracer's start (seconds)
        if traced:
            with trace.mark("window"):
                while len(win.rounds) < 2 or time.perf_counter() - t0 < min(
                        TRACE_SECONDS, seconds / 2):
                    win.step(trace.mark)
    # the spans of the rounds run outside the profiler
    n_traced = len(win.rounds)
    obs.reset()
    win.run(seconds, t0)
    window_s = time.perf_counter() - t0
    spans = {name: list(h.values) for name, h in obs.GLOBAL.histograms.items()}

    dev = torch.device(device)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    reduced = trace.reduce(prof) if prof is not None else None
    prof = None
    values, ref = judge_loop(loop, cfg, list(range(first, loop.g + 1)))
    correct, checks = judge.checks(values, cfg["limits"])
    parts["judged"] = time.time() - t_start

    ctx = {"cfg": cfg, "mix": mix, "cell": cell, "warm": loop.warm,
           "stage": _stage(loop.warm), "rounds": win.rounds,
           "traced_rounds": n_traced, "ingest_s": win.ingests,
           "n_iter": win.n_iter, "counts": win.counts,
           "window_s": window_s,
           "setup_s": setup_s, "spans": spans, "trace": reduced,
           "calls": calls, "ref": ref, "on_gpu": dev.type == "cuda",
           "memory_peak_bytes": peak}
    metrics = {}
    for entry in metric_entries(bench, workload, traced):
        value = reader(entry["name"], root).read(ctx)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    result = {"correct": correct, "attempted": len(win.rounds), "failed": 0,
              "metrics": metrics, "device": device_info(dev, peak)}
    if traced and reduced is not None:
        result["device"].update(busy_s=reduced["busy_s"],
                                window_s=reduced["window_s"])
        result["breakdown"] = {"device_ops": reduced["device_ops"],
                               "idle_gaps": reduced["idle_gaps"]}
    # seconds from the process's start to the end of each set-up stage
    # and of the judging
    result["setup_parts"] = parts
    result["checks"] = checks
    return result



def device_info(dev: torch.device, peak) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1, "memory_peak_bytes": peak}


def percentile(values, p: float) -> float:
    """numpy's default (linear) percentile."""
    vals = sorted(values)
    rank = p / 100.0 * (len(vals) - 1)
    lo, hi = math.floor(rank), math.ceil(rank)
    return vals[lo] + (vals[hi] - vals[lo]) * (rank - lo)
