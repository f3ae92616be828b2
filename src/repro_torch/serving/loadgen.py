"""Load generators for the route server -> ``BENCH_torch_serving.json``
(the port of ``repro/serving/loadgen.py``).

Two driving modes against a ``RouteServer`` over a finalized
sketch-only session:

  * closed loop: M caller threads, each routing as soon as its last
    answer returns.  ``batched=False`` sends the same callers through the
    per-request ``route_direct``, which cross-caller batching has to
    beat.
  * open loop: Poisson arrivals at a target rate, submitted without
    waiting; latency counts from the INTENDED arrival time.

The ingest-while-serving row re-uploads keyed sketch waves during the
run and triggers one background warm refinalize midway, so
``staleness_at_serve`` and ``refinalize_under_load_ms`` measure the
ingest-while-finalize path under route traffic; the row also splits the
route latencies into those that started while the refinalize ran and
the others.

The report is schema 1 of ``BENCH_serving.json``: one row per (mode,
batched, concurrency) point with qps, route p50/p99 ms, flush-size and
queue-depth percentiles, timeout and backpressure counts, staleness at
serve and refinalize-under-load latency.  ``config`` also names the
device, and on a GPU the card and its power limit as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` gives them.

    python -m repro_torch.serving.loadgen --clients 4096 --clusters 8 \
        --sketch-dim 64 --callers 4,16 --duration 5 \
        --out BENCH_torch_serving.json
    python -m repro_torch.serving.loadgen --clients 256 --duration 0.5 \
        --device cpu
"""
from __future__ import annotations

import argparse
import json
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import obs, runtime
from repro_torch.core.engine.session import AggregationSession
from repro_torch.device import card_line, resolve_device
from repro_torch.serving.batching import RouteTimeout, ServingError
from repro_torch.serving.server import RouteServer, flush_bucket

SCHEMA_VERSION = 1


# --------------------------------------------------------------- fixture


def make_population(*, clients: int, clusters: int, sketch_dim: int,
                    seed: int = 0, spread: float = 8.0):
    """A separable Gaussian mixture directly in sketch space: cluster
    centers at ``spread * N(0, I)``, unit-variance rows.  Returns
    ``(rows, assignment, centers)`` as numpy arrays."""
    rng = np.random.default_rng(seed)
    centers = spread * rng.standard_normal((clusters, sketch_dim))
    assignment = rng.integers(0, clusters, size=clients)
    rows = centers[assignment] + rng.standard_normal((clients, sketch_dim))
    return (rows.astype(np.float32), assignment,
            centers.astype(np.float32))


def build_session(*, clients: int, clusters: int, sketch_dim: int,
                  seed: int = 0, wave: int = 1024,
                  capacity: Optional[int] = None, mesh=None, device=None):
    """Ingest the mixture in keyed waves and finalize ``kmeans-device``:
    the serving fixture every loadgen mode starts from.  Returns
    ``(session, rows)`` (the rows are the route probes and the re-upload
    pool of the ingest-while-serving row).  Runs on CUDA unless
    ``device="cpu"``.  With ``mesh=`` every rank calls it, and serves as
    ``RouteServer`` says: rank 0 drives, the others follow."""
    rows, _, _ = make_population(clients=clients, clusters=clusters,
                                 sketch_dim=sketch_dim, seed=seed)
    session = AggregationSession(capacity or clients, sketch_dim=sketch_dim,
                                 seed=seed, mesh=mesh, device=device)
    for lo in range(0, clients, wave):
        chunk = rows[lo:lo + wave]
        session.ingest(sketches=chunk,
                       client_ids=list(range(lo, lo + len(chunk))))
    session.finalize(algorithm="kmeans-device", k=clusters)
    return session, rows


def warm_route_buckets(session, probe: np.ndarray, max_batch: int) -> None:
    """Route once at every padded flush size (1, 2, 4, ..., max_batch), so
    that first-launch costs never land inside a measured run."""
    n = 1
    while True:
        session.route(np.repeat(probe[None], n, axis=0))
        if n >= max_batch:
            break
        n = min(n * 2, max_batch)


# ------------------------------------------------------------ generators


def closed_loop(server: RouteServer, probes: np.ndarray, *, callers: int,
                duration_s: float, batched: bool = True,
                timeout: float = 5.0,
                samples: Optional[list] = None) -> dict:
    """Fixed-concurrency driving: each of ``callers`` threads routes
    back-to-back until the deadline.  Returns qps and latency stats; a
    ``samples`` list receives ``(start, ms)`` of every answered request
    (``start`` on ``time.monotonic``)."""
    start = time.monotonic() + 0.05        # let every thread reach the line
    stop_at = start + duration_s
    results: list = [None] * callers

    def worker(tid: int) -> None:
        lat: list = []
        starts: list = []
        n_err = n_to = 0
        idx = tid
        while True:
            now = time.monotonic()
            if now >= stop_at:
                break
            if now < start:
                time.sleep(start - now)
                continue
            sk = probes[idx % len(probes)]
            idx += callers
            t0 = time.perf_counter()
            try:
                if batched:
                    server.route(sk, timeout=timeout)
                else:
                    server.route_direct(sk)
            except RouteTimeout:
                n_to += 1
                continue
            except ServingError:
                n_err += 1
                continue
            lat.append((time.perf_counter() - t0) * 1e3)
            starts.append(now)
        results[tid] = (lat, n_err, n_to, starts)

    threads = [threading.Thread(target=worker, args=(tid,), daemon=True)
               for tid in range(callers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(duration_s + timeout + 10.0)
    lats = [v for r in results if r for v in r[0]]
    n_err = sum(r[1] for r in results if r)
    n_to = sum(r[2] for r in results if r)
    if samples is not None:
        samples.extend((s, v) for r in results if r
                       for s, v in zip(r[3], r[0]))
    return _latency_stats(lats, n_err, n_to, duration_s)


def open_loop(server: RouteServer, probes: np.ndarray, *, rate: float,
              duration_s: float, timeout: float = 5.0) -> dict:
    """Poisson-arrival driving at ``rate`` requests/s; latency is
    completion minus INTENDED arrival."""
    rng = np.random.default_rng(1)
    arrivals: list = []
    t = rng.exponential(1.0 / rate)
    while t < duration_s:
        arrivals.append(t)
        t += rng.exponential(1.0 / rate)
    start = time.monotonic()
    pending: list = []
    n_err = 0
    for i, t_arr in enumerate(arrivals):
        target = start + t_arr
        now = time.monotonic()
        if target > now:
            time.sleep(target - now)
        try:
            fut = server.submit(probes[i % len(probes)], timeout=timeout)
        except ServingError:
            n_err += 1         # shed by backpressure / shutdown
            continue
        pending.append((target, fut))
    lats: list = []
    n_to = 0
    settle_by = time.monotonic() + timeout + 1.0
    for target, fut in pending:
        try:
            fut.result(max(0.01, settle_by - time.monotonic()))
            lats.append((fut.done_at - target) * 1e3)
        except RouteTimeout:
            n_to += 1
        except ServingError:
            n_err += 1
    stats = _latency_stats(lats, n_err, n_to, duration_s)
    stats["offered_rate"] = float(rate)
    return stats


def _percentiles(lats) -> tuple:
    arr = np.asarray(lats, np.float64)
    if not arr.size:
        return None, None
    return float(np.percentile(arr, 50)), float(np.percentile(arr, 99))


def _latency_stats(lats: list, n_err: int, n_to: int,
                   duration_s: float) -> dict:
    p50, p99 = _percentiles(lats)
    return {
        "n_requests": len(lats),
        "n_errors": int(n_err),
        "timeouts": int(n_to),
        "qps": float(len(lats) / duration_s),
        "route_p50_ms": p50,
        "route_p99_ms": p99,
        "duration_s": float(duration_s),
    }


class _IngestLoad:
    """Background keyed re-uploads during a serving run: waves of
    existing client ids get fresh (noised) rows, so capacity stays fixed
    while the live buffer mutates under the served round.  A ``log``
    list receives ``(clock, ids, rows)`` of every wave, the source of a
    serialized replay."""

    def __init__(self, server: RouteServer, rows: np.ndarray, *,
                 wave: int = 256, period_s: float = 0.2, seed: int = 7,
                 log: Optional[list] = None):
        self.server, self.rows = server, rows
        self.wave, self.period_s = int(wave), float(period_s)
        self.rng = np.random.default_rng(seed)
        self.log = log
        self.waves_done = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        n = len(self.rows)
        while not self._stop.is_set():
            ids = self.rng.choice(n, size=min(self.wave, n), replace=False)
            noise = 0.1 * self.rng.standard_normal(
                (len(ids), self.rows.shape[1])).astype(np.float32)
            chunk = self.rows[ids] + noise
            ids = [int(i) for i in ids]
            _, clock = self.server.ingest(sketches=chunk, client_ids=ids)
            if self.log is not None:
                self.log.append((clock, ids, chunk))
            self.waves_done += 1
            self._stop.wait(self.period_s)

    def start(self) -> "_IngestLoad":
        self._thread.start()
        return self

    def stop(self) -> int:
        self._stop.set()
        self._thread.join(30.0)
        return self.waves_done


# ------------------------------------------------------------ bench rows


def run_row(session, probes, *, mode: str, batched: bool,
            callers: Optional[int] = None, rate: Optional[float] = None,
            duration_s: float = 5.0, max_batch: int = 64,
            max_wait_ms: float = 0.5, queue_depth: int = 1024,
            ingest: bool = False, ingest_log: Optional[list] = None,
            config: Optional[dict] = None) -> dict:
    """One bench point: a fresh ``RouteServer`` over the shared session,
    one load-generator run, the obs aggregates folded into the row."""
    obs.reset()
    warm_route_buckets(session, probes[0], max_batch)
    server = RouteServer(session, max_batch=max_batch,
                         max_wait_ms=max_wait_ms, queue_depth=queue_depth)
    server.start()
    load = None
    refinal = None
    window = {}
    timer = None
    samples: list = []
    try:
        if ingest:
            load = _IngestLoad(server, probes, log=ingest_log).start()

            # one warm refinalize midway, computed on a snapshot while
            # ingest and routes go on
            def _trigger():
                nonlocal refinal
                window["start"] = time.monotonic()
                refinal = server.refinalize(background=True)
            timer = threading.Timer(duration_s / 2, _trigger)
            timer.daemon = True
            timer.start()
        if mode == "closed":
            stats = closed_loop(server, probes, callers=int(callers),
                                duration_s=duration_s, batched=batched,
                                samples=samples)
        elif mode == "open":
            stats = open_loop(server, probes, rate=float(rate),
                              duration_s=duration_s)
        else:
            raise ValueError(f"mode must be closed|open, got {mode!r}")
        if timer is not None:
            timer.join(duration_s + 10.0)
        if refinal is not None:
            refinal.result(120.0)
            window["end"] = refinal.done_at
    finally:
        if timer is not None:
            timer.cancel()
        waves = load.stop() if load is not None else 0
        server.stop(drain=True)
    snap = obs.snapshot()
    hists = snap["histograms"]
    # flushes by the row count they launched at (one kmeans_assign each)
    flushes = obs.GLOBAL.histograms.get("serving.flush_size")
    buckets: dict = {}
    for n in (flushes.values if flushes is not None else ()):
        b = flush_bucket(int(n), max_batch)
        buckets[b] = buckets.get(b, 0) + 1
    counters = snap["counters"]

    def _h(name, field):
        h = hists.get(name, {})
        return h.get(field) if h.get("count") else None

    row = {
        "mode": mode,
        "batched": bool(batched),
        "callers": None if callers is None else int(callers),
        "rate": None if rate is None else float(rate),
        "max_batch": int(max_batch),
        "max_wait_ms": float(max_wait_ms),
        "queue_depth": int(queue_depth),
        "ingest_waves": int(waves),
        "backpressure": int(counters.get("serving.backpressure", 0)),
        "flush_errors": int(counters.get("serving.flush_errors", 0)),
        "flush_size_p50": _h("serving.flush_size", "p50"),
        "flush_size_p95": _h("serving.flush_size", "p95"),
        "flush_size_max": _h("serving.flush_size", "max"),
        "flushes_by_bucket": {str(b): buckets[b] for b in sorted(buckets)},
        "queue_depth_p95": _h("serving.queue_depth", "p95"),
        "staleness_at_serve_p95": _h("serving.staleness_at_serve", "p95"),
        "refinalize_under_load_ms": _h("serving.refinalize_under_load.ms",
                                       "p50"),
        "drops": 0,     # every submitted request resolves: result/timeout
        **stats,
    }
    if "end" in window:
        # routes that started while the refinalize ran, and the others
        during = [ms for t, ms in samples
                  if window["start"] <= t <= window["end"]]
        outside = [ms for t, ms in samples
                   if not window["start"] <= t <= window["end"]]
        row["refinalize_window_ms"] = (window["end"]
                                       - window["start"]) * 1e3
        row["n_requests_during_refinalize"] = len(during)
        (row["route_p50_ms_during_refinalize"],
         row["route_p99_ms_during_refinalize"]) = _percentiles(during)
        (row["route_p50_ms_outside_refinalize"],
         row["route_p99_ms_outside_refinalize"]) = _percentiles(outside)
    if config:
        row.update(config)
    return row


def run(*, clients: int = 4096, clusters: int = 8, sketch_dim: int = 64,
        callers=(4, 16), duration_s: float = 5.0, max_batch: int = 64,
        max_wait_ms: float = 0.5, queue_depth: int = 1024,
        open_rate: Optional[float] = None, ingest: bool = True,
        seed: int = 0, out: Optional[str] = None, device=None) -> dict:
    """The full sweep: per concurrency point one batched and one
    per-request closed-loop row, then (optionally) one batched row under
    ingest and one open-loop row; returns the schema-1 report with the
    batched-beats-per-request criterion.  Runs on CUDA unless
    ``device="cpu"``."""
    dev = resolve_device(device)
    config = {"clients": int(clients), "clusters": int(clusters),
              "sketch_dim": int(sketch_dim)}
    session, rows = build_session(clients=clients, clusters=clusters,
                                  sketch_dim=sketch_dim, seed=seed,
                                  device=dev)
    bench_rows: list = []
    criterion: dict = {}
    for m in callers:
        direct = run_row(session, rows, mode="closed", batched=False,
                         callers=m, duration_s=duration_s,
                         max_batch=max_batch, max_wait_ms=max_wait_ms,
                         queue_depth=queue_depth, config=config)
        batched = run_row(session, rows, mode="closed", batched=True,
                          callers=m, duration_s=duration_s,
                          max_batch=max_batch, max_wait_ms=max_wait_ms,
                          queue_depth=queue_depth, config=config)
        bench_rows += [direct, batched]
        criterion[f"callers={m}"] = {
            "batched_qps": batched["qps"],
            "direct_qps": direct["qps"],
            "speedup": (batched["qps"] / direct["qps"]
                        if direct["qps"] else None),
            "pass": batched["qps"] > direct["qps"],
        }
        print(f"closed callers={m}: direct {direct['qps']:.0f}/s, "
              f"batched {batched['qps']:.0f}/s "
              f"(p50 {batched['route_p50_ms']:.3f}ms)", flush=True)
    if ingest:
        under = run_row(session, rows, mode="closed", batched=True,
                        callers=max(callers), duration_s=duration_s,
                        max_batch=max_batch, max_wait_ms=max_wait_ms,
                        queue_depth=queue_depth, ingest=True,
                        config=config)
        bench_rows.append(under)
        ref_ms = under["refinalize_under_load_ms"]
        print(f"under-ingest callers={max(callers)}: "
              f"{under['qps']:.0f}/s, refinalize "
              f"{'n/a' if ref_ms is None else f'{ref_ms:.1f}ms'}, "
              f"{under['ingest_waves']} waves", flush=True)
    if open_rate:
        op = run_row(session, rows, mode="open", batched=True,
                     rate=open_rate, duration_s=duration_s,
                     max_batch=max_batch, max_wait_ms=max_wait_ms,
                     queue_depth=queue_depth, config=config)
        bench_rows.append(op)
        print(f"open rate={open_rate}/s: served {op['qps']:.0f}/s "
              f"(p99 {op['route_p99_ms']:.3f}ms)", flush=True)
    report = {
        "bench": "serving",
        "schema_version": SCHEMA_VERSION,
        "config": {**config, "duration_s": float(duration_s),
                   "max_batch": int(max_batch),
                   "max_wait_ms": float(max_wait_ms),
                   "queue_depth": int(queue_depth), "seed": int(seed),
                   "device": str(dev), "card": card_line(dev),
                   "torch": torch.__version__},
        "criterion": criterion,
        "rows": bench_rows,
    }
    if out:
        with open(out, "w") as fh:
            json.dump(report, fh, indent=1)
        print(f"wrote {out} ({len(bench_rows)} rows)", flush=True)
    return report


def main(argv=None) -> int:
    runtime.apply_env_presets()          # REPRO_CPU_THREADS
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--clients", type=int, default=4096)
    ap.add_argument("--clusters", type=int, default=8)
    ap.add_argument("--sketch-dim", type=int, default=64)
    ap.add_argument("--callers", default="4,16",
                    help="comma-separated closed-loop concurrency points")
    ap.add_argument("--duration", type=float, default=5.0)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--max-wait-ms", type=float, default=0.5)
    ap.add_argument("--queue-depth", type=int, default=1024)
    ap.add_argument("--open-rate", type=float, default=None,
                    help="also run one Poisson open-loop row at this rate")
    ap.add_argument("--no-ingest", action="store_true",
                    help="skip the ingest-while-serving row")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--floor-qps", type=float, default=None,
                    help="exit 1 unless the best batched closed-loop row "
                         "reaches this many routes/s")
    ap.add_argument("--require-criterion", action="store_true",
                    help="exit 1 unless batched beats per-request at every "
                         "concurrency point")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    callers = tuple(int(c) for c in str(args.callers).split(",") if c)
    report = run(clients=args.clients, clusters=args.clusters,
                 sketch_dim=args.sketch_dim, callers=callers,
                 duration_s=args.duration, max_batch=args.max_batch,
                 max_wait_ms=args.max_wait_ms,
                 queue_depth=args.queue_depth, open_rate=args.open_rate,
                 ingest=not args.no_ingest, seed=args.seed, out=args.out,
                 device=args.device)
    if not all(c["pass"] for c in report["criterion"].values()):
        print("criterion not met: cross-caller batching did not beat "
              "per-request routing at every concurrency point")
        if args.require_criterion:
            return 1
    if args.floor_qps is not None:
        best = max(r["qps"] for r in report["rows"]
                   if r["mode"] == "closed" and r["batched"])
        if best < args.floor_qps:
            print(f"floor FAILED: best batched qps {best:.0f} < "
                  f"{args.floor_qps}")
            return 1
        print(f"floor OK: best batched qps {best:.0f} >= {args.floor_qps}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
