"""Large-C client simulation of the one-shot ODCL-KM round (the port of
``repro/launch/simulate.py``'s ``odcl`` path).

Clients are drawn and solved in waves: each wave draws ``wave``
clients' covariates and responses from their cluster's ridge model,
solves every closed-form local ERM in one batched solve, and ingests the
wave into an ``AggregationSession`` (JL sketch on the device).  The
server round is ``session.finalize()`` (kmeans++ seeding, Lloyd,
per-cluster parameter mean).  ``finalize_repeats`` counts the finalizes
in all: the first is reported alone (``finalize_first_ms``), the warm
repeats give the finalize percentiles.  ``route_probes`` then routes
fresh, never-seen clients one request at a time (latency percentiles
over those calls only) and as one batch (throughput); the two must give
the same labels.

  python -m repro_torch.launch.simulate --clients 4096 --clusters 8
  python -m repro_torch.launch.simulate --clients 4096 --device cpu
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.clustering.api import LLOYD_DEVICE_INIT, list_algorithms
from repro_torch.core.engine.session import AggregationSession
from repro_torch.core.erm import batched_ridge_erm
from repro_torch.core.federated import (
    cluster_agreement,
    params_bytes_per_client,
    sketch_round_bytes,
)
from repro_torch.core.sketch import make_generator
from repro_torch.device import resolve_device


def staggered_optima(generator: torch.Generator, K: int, d: int):
    """Well-separated cluster optima in the style of Appendix E.1:
    cluster k draws coordinate magnitudes from U([k + 1, k + 2]) with an
    independent random sign per coordinate."""
    dev = generator.device
    signs = torch.randint(0, 2, (K, d), generator=generator,
                          device=dev).to(torch.float32) * 2.0 - 1.0
    base = torch.arange(1.0, K + 1.0, dtype=torch.float32, device=dev)[:, None]
    return signs * (base + torch.rand((K, d), generator=generator,
                                      device=dev))


def wave_ridge_erm(generator: torch.Generator, optima, labels, *, n: int,
                   noise: float = 1.0, reg: float = 1e-6):
    """One wave of step 1: draw each client's (n, d) covariates and noisy
    responses from its cluster's optimum, solve every ridge ERM.
    Returns the (wave, d) stack of local models on the optima's device."""
    w, d = labels.shape[0], optima.shape[1]
    x = torch.randn((w, n, d), generator=generator, device=optima.device)
    z = torch.einsum("wnd,wd->wn", x, optima[labels])
    y = z + noise * torch.randn((w, n), generator=generator,
                                device=optima.device)
    return batched_ridge_erm(x, y, reg)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def simulate(*, clients: int, clusters: int, dim: int = 16, samples: int = 64,
             wave: int = 4096, sketch_dim: int = 64,
             algorithm: str = "kmeans-device", init: str = "kmeans++",
             kmeans_iters: int = 50, restarts: int = 1, seed: int = 0,
             route_probes: int = 0, finalize_repeats: int = 1,
             device=None) -> dict:
    """Stream a K-cluster federation of ``clients`` ridge clients into an
    ``AggregationSession``, run the one-shot round, and return a summary
    (per-phase wall clock, purity, MSE, serving latencies).  Runs on CUDA
    unless ``device="cpu"``."""
    dev = resolve_device(device)
    obs.reset()
    gen = make_generator(seed, dev)
    optima = staggered_optima(gen, clusters, dim)
    true_labels = torch.arange(clients, device=dev) % clusters

    session = AggregationSession(clients, sketch_dim=sketch_dim, seed=seed,
                                 device=dev)
    t_erm = t_ingest = 0.0
    for start in range(0, clients, wave):
        w = min(wave, clients - start)
        t0 = time.perf_counter()
        theta_w = wave_ridge_erm(gen, optima, true_labels[start:start + w],
                                 n=samples)
        _sync(dev)
        t1 = time.perf_counter()
        session.ingest({"theta": theta_w})
        t_erm += t1 - t0
        t_ingest += time.perf_counter() - t1

    algo_options = {"init": init, "iters": kmeans_iters, "restarts": restarts}
    t1 = time.perf_counter()
    new_state, labels, info = session.finalize(
        algorithm=algorithm, k=clusters, algo_options=algo_options)
    _sync(dev)
    t_agg = time.perf_counter() - t1

    truth = true_labels.cpu().numpy()
    purity = cluster_agreement(labels, truth)
    served = new_state.params["theta"]
    mse = float(torch.mean((served - optima[true_labels]) ** 2))

    serving = None
    if route_probes > 0 or finalize_repeats > 1:
        # warm finalizes only: the first one above also pays first-call
        # set-up (allocator growth, kernel loading)
        h_fin = obs.Histogram()
        for _ in range(max(0, finalize_repeats - 1)):
            tf = time.perf_counter()
            session.finalize(algorithm=algorithm, k=clusters,
                             algo_options=algo_options)
            _sync(dev)
            h_fin.observe((time.perf_counter() - tf) * 1e3)
        serving = {"finalize_first_ms": t_agg * 1e3,
                   "finalize_repeats": finalize_repeats,
                   "finalize_warm_count": h_fin.count,
                   "finalize_p50_ms": (h_fin.percentile(50.0)
                                       if h_fin.count else None),
                   "finalize_p99_ms": (h_fin.percentile(99.0)
                                       if h_fin.count else None),
                   "route_probes": route_probes}
        if route_probes > 0:
            # fresh never-seen clients from the same population
            probe_truth = torch.arange(route_probes, device=dev) % clusters
            theta_p = wave_ridge_erm(gen, optima, probe_truth, n=samples)
            _sync(dev)
            session.route(params={"theta": theta_p[0]})        # warmup
            # one client per request: each call's latency, and its label
            h_route = obs.Histogram()
            single = np.empty(route_probes, np.int64)
            tr = time.perf_counter()
            for i in range(route_probes):
                t0 = time.perf_counter()
                single[i] = session.route(params={"theta": theta_p[i]})
                h_route.observe((time.perf_counter() - t0) * 1e3)
            routes_per_s = route_probes / (time.perf_counter() - tr)
            # the batched path: one program per request batch
            sk_p = session.sketch_params({"theta": theta_p})
            routed = session.route(sk_p)                       # warmup
            reps = 10
            tb = time.perf_counter()
            for _ in range(reps):
                session.route(sk_p)
            batch_s = (time.perf_counter() - tb) / reps
            probe_truth = probe_truth.cpu().numpy()
            serving.update({
                "route_p50_ms": h_route.percentile(50.0),
                "route_p99_ms": h_route.percentile(99.0),
                "routes_per_s": routes_per_s,
                "route_single_purity": cluster_agreement(single,
                                                         probe_truth),
                # the same clients routed one by one and as one batch
                "route_single_vs_batch": float(np.mean(single == routed)),
                "route_batch_ms": batch_s * 1e3,
                "batched_routes_per_s": route_probes / batch_s,
                "route_purity": cluster_agreement(routed, probe_truth),
            })
        serving["drift"] = session.drift

    return {
        "clients": clients, "clusters": clusters, "dim": dim,
        "samples": samples, "wave": wave, "task": "ridge",
        "sketch_dim": sketch_dim, "seed": seed, "method": "odcl",
        "algorithm": algorithm, "init": init, "restarts": restarts,
        "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "comm_rounds": 1.0,
        "comm_bytes": sketch_round_bytes(
            clients, sketch_dim, params_bytes_per_client(new_state)),
        "phases": {"local_erm_s": t_erm, "ingest_s": t_ingest,
                   "aggregate_s": t_agg,
                   "total_s": t_erm + t_ingest + t_agg},
        "n_clusters_recovered": info["n_clusters"],
        "purity": purity,
        "mse": mse,
        "meta": {"engine": info["engine"], **info["meta"]},
        "serving": serving,
        "obs": obs.snapshot(),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--clients", type=int, default=4096)
    ap.add_argument("--clusters", type=int, default=8)
    ap.add_argument("--dim", type=int, default=16)
    ap.add_argument("--samples", type=int, default=64,
                    help="data points per client (n)")
    ap.add_argument("--wave", type=int, default=4096,
                    help="clients drawn+solved+ingested per wave")
    ap.add_argument("--sketch-dim", type=int, default=64)
    ap.add_argument("--algorithm", default="kmeans-device",
                    choices=sorted({*list_algorithms(), *LLOYD_DEVICE_INIT}))
    ap.add_argument("--init", choices=("kmeans++", "random"),
                    default="kmeans++")
    ap.add_argument("--kmeans-iters", type=int, default=50)
    ap.add_argument("--restarts", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--route-probes", type=int, default=0)
    ap.add_argument("--finalize-repeats", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="write the summary JSON here")
    args = ap.parse_args(argv)
    summary = simulate(
        clients=args.clients, clusters=args.clusters, dim=args.dim,
        samples=args.samples, wave=args.wave, sketch_dim=args.sketch_dim,
        algorithm=args.algorithm, init=args.init,
        kmeans_iters=args.kmeans_iters, restarts=args.restarts,
        seed=args.seed, route_probes=args.route_probes,
        finalize_repeats=args.finalize_repeats, device=args.device)
    ph = summary["phases"]
    print(f"[simulate] C={summary['clients']} K={summary['clusters']} "
          f"wave={summary['wave']} algo={summary['algorithm']} "
          f"device={summary['device_name']}")
    print(f"[simulate] local ERMs {ph['local_erm_s']:.3f}s  ingest "
          f"{ph['ingest_s']:.3f}s  server round {ph['aggregate_s']:.3f}s")
    print(f"[simulate] recovered K'={summary['n_clusters_recovered']} "
          f"purity={summary['purity']:.3f} mse={summary['mse']:.3g} "
          f"n_iter={summary['meta']['n_iter']}")
    sv = summary["serving"]
    if sv is not None and sv["finalize_p50_ms"] is not None:
        print(f"[simulate] finalize: first {sv['finalize_first_ms']:.3f}ms, "
              f"warm p50={sv['finalize_p50_ms']:.3f}ms over "
              f"{sv['finalize_warm_count']}")
    if sv is not None and sv.get("route_p50_ms") is not None:
        print(f"[simulate] serving: route p50={sv['route_p50_ms']:.3f}ms "
              f"p99={sv['route_p99_ms']:.3f}ms "
              f"({sv['routes_per_s']:.0f}/s), batch of {sv['route_probes']} "
              f"in {sv['route_batch_ms']:.3f}ms")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2)
        print(f"[simulate] wrote {args.out}")
    return summary


if __name__ == "__main__":
    main()
