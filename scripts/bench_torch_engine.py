"""The port's engine-scaling bench -> ``BENCH_torch_engine.json``: the
rows of the reference's ``benchmarks/bench_engine_scale.py`` (schema 4,
the same ``SWEEPS`` and row keys: algorithm, edges, C, shards), run by
the port's ``launch.simulate.simulate`` on one GPU.

    PYTHONPATH=src python3 scripts/bench_torch_engine.py \
        [--out BENCH_torch_engine.json] [--device cuda]

Each (algorithm, edge set, C) row streams the ridge federation into a
session, finalizes it, serves it (routes, warm finalizes, and for the
kmeans rows the mutation knobs' re-uploads, churn and warm refinalize)
and records the summary with:

  * ``kernels.programs``: each engine program's flops and bytes gauges
    (counted from shapes over the kernel calls it made,
    ``roofline/kernel_costs.py``) against its warm p50, as fractions of
    the H100's fp32 peaks (``roofline.engine_costs``);
  * ``kernels.probes``: the per-iteration kernel timed alone at the row's
    sizes (a hierarchical row at one shard's);
  * ``device_peak_bytes``: ``torch.cuda.max_memory_allocated`` over the
    row (reset before it), ``device_peak_bytes_source`` =
    ``"cuda_allocator"``; the process's peak RSS beside it;
  * ``edge_build_s`` on the convex rows: the warm time of the registered
    edge builder alone at the row's (C, sketch_dim).

``hw`` names the peaks, the card and its power limit.  The reference's
file was written on a CPU (``hw: cpu-nominal``), so the two files compare
by schema and by the ``n_clusters_recovered``, ``purity`` and ``mse``
columns, never by time.  ``SWEEPS`` and the edge-build timing are
copies: ``benchmarks/`` belongs to the reference.  Imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import resource
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.engine.edges import get_edge_set  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.simulate import simulate  # noqa: E402
from repro_torch.roofline.engine_costs import (  # noqa: E402
    detect_hardware,
    engine_kernel_report,
    hardware_info,
    program_rows_from_snapshot,
)

CLUSTERS = 8
OUT = "BENCH_torch_engine.json"
SCHEMA_VERSION = 4
# (algorithm, C grid, simulate overrides), as the reference's bench: the
# kmeans rows carry the mutation knobs, so each row also measures the
# mutable-serving path after the scored run
SWEEPS = (
    ("kmeans-device", (256, 1024, 4096, 16384),
     {"finalize_repeats": 5, "route_probes": 256,
      "reupload_frac": 0.25, "churn": 64, "refinalize_threshold": 1.5}),
    # two-level hierarchical rounds: S shards of the round, then the
    # S k shard centers at the top level
    ("kmeans-device", (102400,),
     {"shards": 8, "wave": 8192, "route_probes": 256}),
    ("kmeans-device", (1048576,),
     {"shards": 32, "wave": 8192, "route_probes": 256}),
    ("convex-device", (256, 1024),
     {"sketch_dim": 32, "cc_iters": 200,
      "finalize_repeats": 3, "route_probes": 256}),
    # the complete graph's wall row: one finalize
    ("convex-device", (4096,),
     {"sketch_dim": 32, "cc_iters": 200,
      "finalize_repeats": 1, "route_probes": 256}),
    # the sparse mutual-kNN fusion graph, past the complete graph's wall
    ("convex-device", (4096, 16384),
     {"sketch_dim": 32, "cc_iters": 200, "edges": "knn", "knn_k": 8,
      "finalize_repeats": 2, "route_probes": 256}),
    # approximate kNN: the LSH candidates drop the O(C^2) distance sweep
    ("convex-device", (16384,),
     {"sketch_dim": 32, "cc_iters": 200, "edges": "knn-approx", "knn_k": 8,
      "finalize_repeats": 2, "route_probes": 256}),
)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def edge_build_seconds(c: int, sketch_dim: int, edges: str, knn_k: int,
                       dev: torch.device, repeats: int = 3) -> float:
    """Warm wall time of the registered edge builder alone at the row's
    shapes (the median of ``repeats`` after one warm-up), so that the
    exact and the approximate kNN compare on the build alone."""
    gen = torch.Generator(device=dev).manual_seed(0)
    pts = torch.randn((c, sketch_dim), generator=gen, device=dev)
    builder = get_edge_set(edges)
    builder(pts, knn_k=knn_k)
    _sync(dev)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        builder(pts, knn_k=knn_k)
        _sync(dev)
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def _peak_bytes(dev: torch.device) -> dict:
    """The allocator's peak over the row on the card; the process's peak
    RSS (a high-water mark over the whole run) beside it."""
    peak_rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    if dev.type == "cuda":
        return {"device_peak_bytes": int(torch.cuda.max_memory_allocated(dev)),
                "device_peak_bytes_source": "cuda_allocator",
                "peak_rss_bytes": peak_rss}
    return {"device_peak_bytes": None, "device_peak_bytes_source": None,
            "peak_rss_bytes": peak_rss}


def run(sweeps=SWEEPS, out: str = OUT, device=None) -> dict:
    dev = resolve_device(device)
    hw = detect_hardware(dev)
    rows = []
    for algorithm, c_grid, overrides in sweeps:
        tag = algorithm
        if overrides.get("edges", "complete") != "complete":
            tag = f"{algorithm}+{overrides['edges']}"
        if overrides.get("shards", 1) > 1:
            tag = f"{tag}@S{overrides['shards']}"
        for c in c_grid:
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            summary = simulate(clients=c, clusters=CLUSTERS,
                               algorithm=algorithm, device=dev,
                               **{"wave": 4096, **overrides})
            snap = summary.pop("obs")
            serving = summary.pop("serving") or {}
            peak = _peak_bytes(dev)
            # a hierarchical row probes one shard's level-0 shapes, the
            # sizes its rounds run at
            probe_c = -(-c // summary.get("shards", 1))
            probes = engine_kernel_report(
                probe_c, summary["sketch_dim"], CLUSTERS, algorithm,
                edges=summary.get("edges") or "complete",
                knn_k=summary.get("knn_k") or 8, hw=hw, device=dev)
            edge_build_s = None
            if summary.get("edges") is not None:
                edge_build_s = edge_build_seconds(
                    c, summary["sketch_dim"], summary["edges"],
                    summary.get("knn_k") or 8, dev)
            row = {**summary, **serving, **peak,
                   "edge_build_s": edge_build_s,
                   "kernels": {
                       "programs": program_rows_from_snapshot(snap, hw),
                       "probes": probes}}
            rows.append(row)
            ph = summary["phases"]
            print(f"bench_engine/{tag}/C{c}: aggregate_s="
                  f"{ph['aggregate_s']:.4f} erm_s={ph['local_erm_s']:.3f} "
                  f"ingest_s={ph['ingest_s']:.3f} "
                  f"purity={summary['purity']:.4f} "
                  f"K'={summary['n_clusters_recovered']} "
                  f"finalize_p50_ms={serving.get('finalize_p50_ms')} "
                  f"route_p50_ms={serving.get('route_p50_ms')} "
                  f"peak={peak['device_peak_bytes']}", flush=True)
    report = {"bench": "engine_scale", "schema_version": SCHEMA_VERSION,
              "backend": dev.type, "clusters": CLUSTERS,
              "hw": hardware_info(hw, dev), "rows": rows}
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {out} ({len(rows)} rows) on {report['hw']['card']}",
          flush=True)
    return report


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--device", default=None,
                    help="cpu for a rehearsal with the plain versions "
                         "(default: the card)")
    args = ap.parse_args(argv)
    run(out=args.out, device=args.device)


if __name__ == "__main__":
    main()
