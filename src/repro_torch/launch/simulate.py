"""Large-C client simulation of the one-shot ODCL round and the
iterative baselines (the port of ``repro/launch/simulate.py``).

Clients are drawn and solved in waves: each wave draws ``wave`` clients'
covariates and responses from their cluster's model (``--task ridge``:
noisy linear responses, closed-form ridge ERMs; ``--task logistic``:
labels y = +-1 ~ sigmoid(z), 8 Newton steps, d + 1 parameters a client),
solves every local ERM in one batched solve, and ingests the wave into
an ``AggregationSession`` (JL sketch on the device). The server round is
``session.finalize()``: ODCL-KM (``kmeans-device``: kmeans++, spectral
or random seeding, then Lloyd; the host Lloyd names map onto it),
gradient clustering (``gradient-device``) or ODCL-CC
(``convex-device`` at the paper's E.1 exact lambda, the midpoint of the
recovery interval (17) of the true clustering; ``clusterpath-device``,
K-free; ``--edges`` picks the fusion graph), then the per-cluster
parameter reduction (``--aggregator``; a robust one also drives the
Lloyd center update).  ``--trace PATH`` writes every span and event of
the run as JSON lines. ``finalize_repeats`` counts the
finalizes in all: the first is reported alone (``finalize_first_ms``),
the warm repeats give the finalize percentiles. ``route_probes`` then
routes fresh, never-seen clients one request at a time (latency
percentiles over those calls only) and as one batch (throughput); the
two must give the same labels.

The mutation knobs (``reupload_frac``, ``churn``, ``max_age``,
``refinalize_threshold``) key the initial waves by client id, then run
``mutation_rounds`` rounds against shifted optima: a keyed re-upload of
a fraction of the clients and ``churn`` new joiners each round, under the
sliding-window staleness policy; drifted probes then feed the drift
gauge and ``maybe_refinalize`` warm-starts a re-finalize
(``refinalize_fired``, ``refinalize_warm_p50_ms``).  ``qps_callers``
runs the ``RouteServer`` over the finalized session: closed-loop callers
per request, then batched across callers.

``scenario`` runs the federation through an adversity scenario
(``repro_torch.scenarios``, options from one flat ``scenario_options``
set): its population and drift hooks reshape the true labels (which are
then scored), ``corrupt_uploads`` attacks each wave's ERMs before upload,
and its sketch hook (the DP release, the colluding spoof) runs inside the
session's ingest.  ``purity`` and ``mse`` count the honest clients only
(``purity_all`` every client).  ``shards > 1`` runs the two-level
hierarchical round (``core/engine/hierarchy.py``): one finalize per
shard of ceil(C / shards) clients, then one over the shards' centers;
``comm_level_bytes`` gives both levels' bytes.  It is anonymous-only and
one-shot-only, so it refuses the mutation knobs and ``qps_callers``.

``method`` (``--method``, any of ``list_federated_methods()``) other than
``odcl`` runs that method over ``session.state()``, the streamed-in
federation as a stacked state, for ``rounds`` rounds with no local step
(the shallow clients are at their local optima): IFCA assigns by sketch
through ``kmeans_assign`` from k spread clients; no serving follows.

``mesh`` (a ``DeviceMesh``, e.g. ``launch.mesh.client_mesh``) runs the
round with the client axis on its ``client_axis`` dim, one process a
rank: every rank draws every wave from the seed and its session keeps
the rows it owns; the labels, the purity and the MSE cover every
client.  The other methods run on the gathered federation.  There is no
CLI flag for it, as in the reference.  Under a mesh the route server
(``qps_callers``) runs on rank 0 alone, over its session (the served
centers are replicated, so a route sends no collective), as the
reference's single controller runs it; the other ranks wait at a
barrier, and only rank 0's summary has ``qps_server``.

  python -m repro_torch.launch.simulate --clients 4096 --clusters 8
  python -m repro_torch.launch.simulate --clients 4096 --device cpu
  python -m repro_torch.launch.simulate --algorithm convex-device \
      --edges knn --clients 512 --device cpu
  python -m repro_torch.launch.simulate --clients 4096 --reupload-frac 0.25 \
      --churn 64 --max-age 3 --refinalize-threshold 1.5 --device cpu
  python -m repro_torch.launch.simulate --task logistic --init spectral \
      --aggregator trimmed_mean --trace trace.jsonl --device cpu
  python -m repro_torch.launch.simulate --scenario byzantine \
      --byzantine-frac 0.1 --aggregator trimmed_mean --device cpu
  python -m repro_torch.launch.simulate --shards 4 --scenario dp \
      --dp-epsilon 64 --device cpu
  python -m repro_torch.launch.simulate --method ifca --rounds 5 \
      --clients 4096 --device cpu
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.clustering.api import (
    LLOYD_DEVICE_INIT,
    device_twin,
    get_algorithm,
    is_device_algorithm,
    list_algorithms,
)
from repro_torch.core.clustering.convex import lambda_interval
from repro_torch.core.engine.aggregators import (
    list_aggregators,
    make_aggregator,
)
from repro_torch.core.engine.edges import list_edge_sets
from repro_torch.core.engine.hierarchy import HierarchicalSession
from repro_torch.core.engine.session import AggregationSession
from repro_torch.core.engine.staleness import make_staleness_policy
from repro_torch.core.erm import batched_logistic_erm, batched_ridge_erm
from repro_torch.core.federated import (
    cluster_agreement,
    params_bytes_per_client,
    sketch_round_bytes,
)
from repro_torch.core.federated_methods import (
    build_federated_method,
    list_federated_methods,
)
from repro_torch.core.sketch import make_generator
from repro_torch.device import resolve_device
from repro_torch.scenarios import build_scenario, list_scenarios
from repro_torch.sharding.clients import client_axis_of
from repro_torch.utils import prng, tree_map


class Summary(dict):
    """``simulate``'s summary: a dict of JSON values.  ``round``, an
    attribute and not a key since it holds tensors, is the last installed
    round of the one-shot method (its ``labels``, ``refinalize`` mode,
    route ``centers`` and cluster ``models``), ``None`` for the iterative
    methods."""
    round = None


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


def wave_logistic_erm(generator: torch.Generator, optima, labels, *, n: int,
                      reg: float = 1e-6, newton_iters: int = 8):
    """One wave of the logistic task: labels y = +-1 with P(y = 1) =
    sigmoid(x . optimum), every client's damped-Newton ERM.  Returns the
    (wave, d + 1) stack of local models (w, b)."""
    w, d = labels.shape[0], optima.shape[1]
    x = torch.randn((w, n, d), generator=generator, device=optima.device)
    z = torch.einsum("wnd,wd->wn", x, optima[labels])
    u = torch.rand((w, n), generator=generator, device=optima.device)
    y = 2.0 * (u < torch.sigmoid(z)).to(torch.float32) - 1.0
    return batched_logistic_erm(x, y, reg, newton_iters)


def wave_erm(generator: torch.Generator, optima, labels, *, n: int,
             task: str = "ridge"):
    """One wave of step 1 for ``task`` (``ridge`` | ``logistic``)."""
    if task == "ridge":
        return wave_ridge_erm(generator, optima, labels, n=n)
    if task == "logistic":
        return wave_logistic_erm(generator, optima, labels, n=n)
    raise ValueError(f"unknown task {task!r}")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


def simulate(*, clients: int, clusters: int, dim: int = 16, samples: int = 64,
             wave: int = 4096, task: str = "ridge", sketch_dim: int = 64,
             shards: int = 1,
             algorithm: str = "kmeans-device", init: str = "kmeans++",
             kmeans_iters: int = 50, restarts: int = 1,
             cc_iters: int = 300, edges: str = "complete", knn_k: int = 8,
             scenario=None, scenario_options: dict | None = None,
             aggregator: str = "mean", trim_beta: float = 0.1,
             seed: int = 0, method: str = "odcl", rounds: int = 5,
             trace: str | None = None,
             route_probes: int = 0, finalize_repeats: int = 1,
             reupload_frac: float = 0.0, churn: int = 0,
             max_age: int | None = None,
             refinalize_threshold: float | None = None,
             mutation_rounds: int = 3, drift_scale: float = 2.0,
             qps_callers: int = 0, qps_duration: float = 2.0,
             mesh=None, client_axis: str = "data",
             device=None) -> "Summary":
    """Stream a K-cluster federation of ``clients`` ridge or logistic
    clients into an ``AggregationSession``, run the one-shot round, and
    return a summary (per-phase wall clock, purity, MSE of the ridge
    task, serving latencies).  ``trace`` attaches a JSONL sink for the
    run.  ``mesh`` / ``client_axis`` shard the client axis (see the
    module docstring).  Runs on CUDA unless ``device="cpu"``."""
    dev = resolve_device(device)
    mutated = (reupload_frac > 0 or churn > 0 or max_age is not None
               or refinalize_threshold is not None)
    if shards > 1 and mutated:
        # the hierarchical server is anonymous-only: keyed mutation needs
        # the flat session's single buffer
        raise ValueError("--shards > 1 is incompatible with the mutation "
                         "knobs (--reupload-frac/--churn/--max-age/"
                         "--refinalize-threshold): keyed slots need the "
                         "flat session")
    if shards > 1 and method != "odcl":
        raise ValueError(f"--shards > 1 only runs the one-shot round "
                         f"(method='odcl'), got method={method!r}")
    if qps_callers > 0 and (shards > 1 or method != "odcl"):
        raise ValueError("--qps-callers needs the flat session's one-shot "
                         "round (shards=1, method='odcl')")
    obs.reset()                       # per-run aggregates; sinks survive
    trace_sink = obs.add_sink(obs.JsonlSink(trace)) if trace else None
    try:
        return _simulate(
            dev, clients=clients, clusters=clusters, dim=dim,
            samples=samples, wave=wave, task=task, sketch_dim=sketch_dim,
            shards=shards, scenario=scenario,
            scenario_options=scenario_options, mutated=mutated,
            algorithm=algorithm, init=init, kmeans_iters=kmeans_iters,
            restarts=restarts, cc_iters=cc_iters, edges=edges, knn_k=knn_k,
            aggregator=aggregator, trim_beta=trim_beta, seed=seed,
            method=method, rounds=rounds,
            route_probes=route_probes, finalize_repeats=finalize_repeats,
            reupload_frac=reupload_frac, churn=churn, max_age=max_age,
            refinalize_threshold=refinalize_threshold,
            mutation_rounds=mutation_rounds, drift_scale=drift_scale,
            qps_callers=qps_callers, qps_duration=qps_duration,
            mesh=mesh, client_axis=client_axis)
    finally:
        if trace_sink is not None:
            obs.remove_sink(trace_sink)
            trace_sink.close()


def _simulate(dev, *, clients, clusters, dim, samples, wave, task,
              sketch_dim, shards, scenario, scenario_options, mutated,
              algorithm, init, kmeans_iters, restarts, cc_iters,
              edges, knn_k, aggregator, trim_beta, seed, method, rounds,
              route_probes,
              finalize_repeats, reupload_frac, churn, max_age,
              refinalize_threshold, mutation_rounds, drift_scale,
              qps_callers, qps_duration, mesh, client_axis) -> "Summary":
    axis = client_axis_of(mesh, client_axis)
    gen = make_generator(seed, dev)
    optima = staggered_optima(gen, clusters, dim)
    scen = (build_scenario(scenario, **(scenario_options or {}))
            if scenario is not None else None)
    scen_key = prng.fold_in(prng.key(seed), 0x5ce0)
    if scen is not None:
        # the hooks are deterministic per global index, so applying the
        # drift hook to the whole index range once equals per-wave calls
        true_labels = scen.wave_labels(
            scen_key, scen.population(scen_key, clients, clusters,
                                      device=dev), 0, clients, clusters)
        honest = scen.honest_mask(scen_key, clients, device=dev).cpu().numpy()
    else:
        true_labels = torch.arange(clients, device=dev) % clusters
        honest = np.ones(clients, bool)
    sketch_hook = (
        (lambda sk, off: scen.sketch_transform(scen_key, sk, off))
        if scen is not None and scen.transforms_sketches else None)

    # mutation mode: keyed slots (client ids) and room for the joiners
    capacity = clients + (churn * mutation_rounds if mutated else 0)
    if shards > 1:
        session = HierarchicalSession(capacity, shards=shards,
                                      sketch_dim=sketch_dim, seed=seed,
                                      sketch_transform=sketch_hook,
                                      mesh=mesh, client_axis=client_axis,
                                      device=dev)
    else:
        session = AggregationSession(capacity, sketch_dim=sketch_dim,
                                     seed=seed, sketch_transform=sketch_hook,
                                     mesh=mesh, client_axis=client_axis,
                                     device=dev)
    agg = make_aggregator(aggregator, beta=trim_beta)
    t_erm = t_ingest = 0.0
    for start in range(0, clients, wave):
        w = min(wave, clients - start)
        t0 = time.perf_counter()
        lab_w = true_labels[start:start + w]
        theta_w = wave_erm(gen, optima, lab_w, n=samples, task=task)
        if scen is not None:
            # step-1 attack: Byzantine clients replace their upload
            theta_w = scen.corrupt_uploads(scen_key, theta_w, lab_w, start,
                                           clients)
        _sync(dev)
        t1 = time.perf_counter()
        session.ingest({"theta": theta_w},
                       client_ids=range(start, start + w) if mutated
                       else None)
        t_erm += t1 - t0
        t_ingest += time.perf_counter() - t1

    convex_family = algorithm.startswith(("convex", "clusterpath"))
    if algorithm.startswith("convex"):
        # paper E.1 exact lambda: the recovery interval (17) of the true
        # clustering of the client models (the JL sketch is near-isometric)
        lo, hi = lambda_interval(axis.full(session.state().params["theta"]),
                                 true_labels.cpu().numpy())
        algo_options = {"lam": 0.5 * (lo + hi) if lo < hi else lo,
                        "iters": cc_iters}
    elif algorithm.startswith("clusterpath"):
        algo_options = {"iters": cc_iters}
    else:
        algo_options = {"init": init, "iters": kmeans_iters,
                        "restarts": restarts}
        if agg.name != "mean":
            # robust Lloyd: the aggregator also replaces the center update
            algo_options["aggregator"] = agg
    if convex_family:
        algo_options.update({"edges": edges, "knn_k": knn_k})
    t1 = time.perf_counter()
    comm_level_bytes = None
    if method == "odcl":
        # the streaming server round over the session's sketches
        new_state, labels, info = session.finalize(
            algorithm=algorithm, k=clusters, algo_options=algo_options,
            aggregator=agg)
        comm_rounds = 1.0
        comm_bytes = sketch_round_bytes(
            clients, sketch_dim, params_bytes_per_client(new_state))
        n_clusters = info["n_clusters"]
        meta = {"engine": info["engine"], **info["meta"]}
        comm_level_bytes = info.get("comm_level_bytes")
    else:
        # iterative methods: sketch-space rounds over the streamed-in
        # federation, its clients' models standing (no local steps)
        fed_method = build_federated_method(
            method, algorithm=algorithm, engine="device", k=clusters,
            algo_options=algo_options, aggregator=agg,
            sketch_dim=sketch_dim, seed=seed, local_steps=0, rounds=rounds,
            assign="sketch", init="clients")
        fed = session.state()       # the methods run on the whole federation
        fed = fed._replace(params=tree_map(axis.full, fed.params))
        res = fed_method.run(seed, fed, None, None, mesh=mesh,
                             client_axis=client_axis)
        new_state, labels = res.state, res.labels
        comm_rounds, comm_bytes = res.comm_rounds, res.comm_bytes
        n_clusters, meta = res.n_clusters, res.meta
    _sync(dev)
    t_agg = time.perf_counter() - t1

    truth = true_labels.cpu().numpy()
    purity_all = cluster_agreement(labels, truth)
    # the score that matters under attack: agreement on the honest
    # clients only (attackers have no "right" cluster)
    purity = (cluster_agreement(labels[honest], truth[honest])
              if honest.any() else purity_all)
    mse = None
    if task == "ridge":
        mse = _mse(axis, new_state.params["theta"], optima[true_labels],
                   torch.as_tensor(honest, device=dev))

    serving = None
    if method == "odcl" and (mutated or route_probes > 0
                             or finalize_repeats > 1):
        # warm finalizes only: the first one above also pays first-call
        # set-up (allocator growth, kernel loading)
        h_fin = obs.Histogram()
        for _ in range(max(0, finalize_repeats - 1)):
            tf = time.perf_counter()
            session.finalize(algorithm=algorithm, k=clusters,
                             algo_options=algo_options, aggregator=agg)
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
            theta_p = wave_erm(gen, optima, probe_truth, n=samples,
                               task=task)
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
        if mutated:
            serving.update(_mutate(
                session, gen, optima, true_labels, samples=samples,
                clusters=clusters, reupload_frac=reupload_frac, churn=churn,
                max_age=max_age, refinalize_threshold=refinalize_threshold,
                mutation_rounds=mutation_rounds, drift_scale=drift_scale,
                finalize_repeats=finalize_repeats, task=task))

    qps_server = None
    if qps_callers > 0:
        qps_server = _qps(session, gen, optima, clusters=clusters,
                          samples=samples, callers=qps_callers,
                          duration_s=qps_duration, task=task, axis=axis)

    summary = Summary({
        "clients": clients, "clusters": clusters, "dim": dim,
        "samples": samples, "wave": wave, "task": task,
        "sketch_dim": sketch_dim, "seed": seed, "method": method,
        "algorithm": algorithm, "init": init, "restarts": restarts,
        "shards": shards, "comm_level_bytes": comm_level_bytes,
        "scenario": getattr(scen, "name", None),
        "scenario_options": scenario_options or None,
        "honest_frac": float(np.mean(honest)),
        # clients per true cluster (after a scenario's population/drift)
        "occupancy": torch.bincount(true_labels.long(),
                                    minlength=clusters).tolist(),
        "aggregator": agg.name,
        "lam": meta.get("lam"),
        "edges": edges if convex_family else None,
        "knn_k": knn_k if convex_family else None,
        "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "comm_rounds": comm_rounds, "comm_bytes": comm_bytes,
        "phases": {"local_erm_s": t_erm, "ingest_s": t_ingest,
                   "aggregate_s": t_agg,
                   "total_s": t_erm + t_ingest + t_agg},
        "n_clusters_recovered": n_clusters,
        "purity": purity,
        "purity_all": purity_all,
        "mse": mse,
        "meta": meta,
        "serving": serving,
        "qps_server": qps_server,
        "obs": obs.snapshot(),
        "mesh": None if mesh is None else {
            "axis": client_axis, "ranks": axis.size, "rank": axis.rank,
            "backend": axis.backend},
    })
    if method == "odcl":
        served = session.served_round if shards == 1 else None
        summary.round = {
            "labels": (served.out[1] if served is not None else labels),
            "refinalize": (served.out[2].get("refinalize")
                           if served is not None else None),
            "centers": session.route_centers,
            "models": session.cluster_models()}
    return summary


def _mse(axis, theta, target, keep) -> float:
    """The ridge MSE over the kept clients, from each rank's chunk of the
    models (``Shard(0)`` or whole on every rank), the sums all-reduced."""
    local, lo = axis.chunk(theta)
    mine = keep[lo:lo + local.shape[0]]
    err = torch.stack([
        torch.sum((local[mine] - target[lo:lo + local.shape[0]][mine]) ** 2),
        torch.sum(mine).to(torch.float32) * local.shape[1]])
    err = axis.all_reduce(err)
    return float(err[0] / err[1])


def _mutate(session, gen, optima, true_labels, *, samples, clusters,
            reupload_frac, churn, max_age, refinalize_threshold,
            mutation_rounds, drift_scale, finalize_repeats, task) -> dict:
    """The drifted-population mutation loop (the reference's): keyed
    re-uploads and joiners drawn around SHIFTED optima, then drifted
    probes routed as one batch to move the drift gauge, then the
    drift-triggered warm re-finalize and its repeats."""
    dev = optima.device
    clients = true_labels.shape[0]
    if max_age is not None:
        session.staleness = make_staleness_policy(f"max_age={max_age}")
    shifted = optima + drift_scale * torch.randn(
        optima.shape, generator=gen, device=dev)
    n_re = int(round(reupload_frac * clients))
    for r in range(mutation_rounds):
        if n_re > 0:
            sel = (np.arange(n_re) + r * n_re) % clients
            theta_m = wave_erm(
                gen, shifted, true_labels[torch.as_tensor(sel, device=dev)],
                n=samples, task=task)
            session.ingest({"theta": theta_m}, client_ids=sel.tolist())
        if churn > 0:
            lab_c = torch.arange(churn, device=dev) % clusters
            theta_c = wave_erm(gen, shifted, lab_c, n=samples, task=task)
            session.ingest({"theta": theta_c},
                           client_ids=[("joiner", r, i)
                                       for i in range(churn)])
    n_probe = 4096
    theta_p = wave_erm(gen, shifted,
                       torch.arange(n_probe, device=dev) % clusters,
                       n=samples, task=task)
    session.route(session.sketch_params({"theta": theta_p}))
    drift_after = session.drift
    refinalize_fired = None
    h_ref = obs.Histogram()
    if refinalize_threshold is not None:
        t0 = time.perf_counter()
        out = session.maybe_refinalize(threshold=refinalize_threshold)
        refinalize_fired = out is not None
        if refinalize_fired:
            h_ref.observe((time.perf_counter() - t0) * 1e3)
        for _ in range(max(0, finalize_repeats - 1)):
            t0 = time.perf_counter()
            session.refinalize()
            h_ref.observe((time.perf_counter() - t0) * 1e3)
    counters = obs.snapshot()["counters"]
    return {
        "reupload_frac": reupload_frac, "churn": churn, "max_age": max_age,
        "mutation_rounds": mutation_rounds,
        "live_clients": session.count,
        "evictions": int(counters.get("session.evictions", 0)),
        "drift_after_mutation": drift_after,
        "refinalize_threshold": refinalize_threshold,
        "refinalize_fired": refinalize_fired,
        "refinalize_count": h_ref.count,
        "refinalize_warm_p50_ms": (h_ref.percentile(50.0)
                                   if h_ref.count else None),
        "refinalize_warm_p99_ms": (h_ref.percentile(99.0)
                                   if h_ref.count else None),
        "refinalize_n_iter": (session.served_round.out[2]["meta"]["n_iter"]
                              if h_ref.count else None),
    }


def _qps(session, gen, optima, *, clusters, samples, callers,
         duration_s, task, axis) -> dict | None:
    """The ``RouteServer`` over the finalized session: ``callers``
    closed-loop threads per request, then batched across callers, then
    every probe through the server against one batch route.  Under a
    mesh rank 0 serves and the others follow its server (``None``)."""
    from repro_torch.serving.loadgen import closed_loop, warm_route_buckets
    from repro_torch.serving.server import RouteServer

    n_probe = 1024
    theta_q = wave_erm(
        gen, optima, torch.arange(n_probe, device=optima.device) % clusters,
        n=samples, task=task)
    probes = session.sketch_params({"theta": theta_q}).cpu().numpy()
    server = RouteServer(session, max_batch=64, max_wait_ms=0.5)
    server.start()
    if axis.rank != 0:
        server.stop()
        return None
    try:
        warm_route_buckets(session, probes[0], 64)
        direct = closed_loop(server, probes, callers=callers,
                             duration_s=duration_s, batched=False)
        batched = closed_loop(server, probes, callers=callers,
                              duration_s=duration_s, batched=True)
        futures = [server.submit(p, timeout=60.0) for p in probes]
        served = np.asarray([f.result(60.0) for f in futures])
    finally:
        server.stop()           # the other ranks go on, whatever happened
    return {
        "callers": int(callers), "duration_s": float(duration_s),
        "direct_qps": direct["qps"], "batched_qps": batched["qps"],
        "batched_p50_ms": batched["route_p50_ms"],
        "batched_p99_ms": batched["route_p99_ms"],
        "direct_p50_ms": direct["route_p50_ms"],
        "direct_p99_ms": direct["route_p99_ms"],
        "timeouts": batched["timeouts"] + direct["timeouts"],
        "errors": batched["n_errors"] + direct["n_errors"],
        "labels_equal_batch_route": bool(np.array_equal(
            served, np.asarray(session.route(probes)))),
    }


def _device_runnable_algorithms() -> list:
    """Registry names the device engine runs: device-capable algorithms,
    names with a registered '-device' twin, and the Lloyd host names the
    shared resolver maps onto kmeans-device inits."""
    return [n for n in list_algorithms()
            if n in LLOYD_DEVICE_INIT
            or is_device_algorithm(get_algorithm(n))
            or device_twin(get_algorithm(n)) is not None]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--clients", type=int, default=4096)
    ap.add_argument("--clusters", type=int, default=8)
    ap.add_argument("--dim", type=int, default=16)
    ap.add_argument("--samples", type=int, default=64,
                    help="data points per client (n)")
    ap.add_argument("--wave", type=int, default=4096,
                    help="clients drawn+solved+ingested per wave")
    ap.add_argument("--task", choices=("ridge", "logistic"), default="ridge")
    ap.add_argument("--sketch-dim", type=int, default=64)
    ap.add_argument("--shards", type=int, default=1,
                    help="level-0 shards of the two-level hierarchical "
                         "round (1 = the flat session; >1 clusters each "
                         "shard, then the shards' centers)")
    ap.add_argument("--algorithm", default="kmeans-device",
                    choices=_device_runnable_algorithms())
    ap.add_argument("--init", choices=("kmeans++", "spectral", "random"),
                    default="kmeans++")
    ap.add_argument("--kmeans-iters", type=int, default=50)
    ap.add_argument("--restarts", type=int, default=1)
    ap.add_argument("--cc-iters", type=int, default=300,
                    help="max AMA iterations for the convex family")
    ap.add_argument("--edges", default="complete",
                    choices=list(list_edge_sets()),
                    help="fusion graph of the convex family: 'complete' "
                         "(the paper's, E = C(C-1)/2), 'knn' (mutual kNN, "
                         "E = C*k) or 'knn-approx' (LSH candidates)")
    ap.add_argument("--knn-k", type=int, default=8,
                    help="neighbours per client for the kNN fusion graphs")
    ap.add_argument("--scenario", default=None,
                    help="adversity scenario over the client population: "
                         f"one of {list(list_scenarios())} or a "
                         "'+'-composed spec (e.g. 'longtail+byzantine')")
    ap.add_argument("--byzantine-frac", type=float, default=None,
                    help="attacker fraction for --scenario byzantine")
    ap.add_argument("--byzantine-attack", default=None,
                    choices=("sign_flip", "noise", "spoof"),
                    help="attack mode for --scenario byzantine")
    ap.add_argument("--byzantine-scale", type=float, default=None,
                    help="noise/spoof magnitude for --scenario byzantine")
    ap.add_argument("--dp-epsilon", type=float, default=None,
                    help="privacy budget for --scenario dp")
    ap.add_argument("--dp-delta", type=float, default=None,
                    help="delta for --scenario dp")
    ap.add_argument("--dp-clip", type=float, default=None,
                    help="sketch L2 clip (sensitivity) for --scenario dp")
    ap.add_argument("--drift-frac", type=float, default=None,
                    help="migrating-client fraction for --scenario drift")
    ap.add_argument("--zipf-a", type=float, default=None,
                    help="Zipf exponent for --scenario longtail")
    ap.add_argument("--aggregator", default="mean",
                    choices=list(list_aggregators()),
                    help="per-cluster step-3 reduction (a robust one also "
                         "drives the Lloyd center update)")
    ap.add_argument("--trim-beta", type=float, default=0.1,
                    help="trim fraction for --aggregator trimmed_mean")
    ap.add_argument("--method", default="odcl",
                    choices=list(list_federated_methods()),
                    help="registered federated method to run over the "
                         "streamed-in federation")
    ap.add_argument("--rounds", type=int, default=5,
                    help="communication rounds (ifca / fedavg)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write every obs span/event of the run as JSONL")
    ap.add_argument("--route-probes", type=int, default=0)
    ap.add_argument("--finalize-repeats", type=int, default=1)
    ap.add_argument("--reupload-frac", type=float, default=0.0,
                    help="fraction of clients re-uploading drifted models "
                         "each mutation round (keyed slot replacement)")
    ap.add_argument("--churn", type=int, default=0,
                    help="fresh clients joining each mutation round")
    ap.add_argument("--max-age", type=int, default=None,
                    help="sliding-window staleness: evict rows older than "
                         "this many waves")
    ap.add_argument("--refinalize-threshold", type=float, default=None,
                    help="drift ratio above which maybe_refinalize() "
                         "warm-starts a re-finalize after the mutation "
                         "rounds")
    ap.add_argument("--qps-callers", type=int, default=0,
                    help="run the RouteServer QPS probe with this many "
                         "closed-loop callers (0 = off)")
    ap.add_argument("--qps-duration", type=float, default=2.0,
                    help="seconds per QPS measurement loop")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="write the summary JSON here")
    args = ap.parse_args(argv)
    # one flat option set; each scenario keeps the fields it declares
    scenario_options = {k: v for k, v in {
        "frac": args.byzantine_frac, "attack": args.byzantine_attack,
        "scale": args.byzantine_scale, "epsilon": args.dp_epsilon,
        "delta": args.dp_delta, "clip": args.dp_clip,
        "drift_frac": args.drift_frac, "zipf_a": args.zipf_a,
    }.items() if v is not None}
    summary = simulate(
        clients=args.clients, clusters=args.clusters, dim=args.dim,
        samples=args.samples, wave=args.wave, task=args.task,
        sketch_dim=args.sketch_dim, shards=args.shards,
        scenario=args.scenario, scenario_options=scenario_options or None,
        algorithm=args.algorithm, init=args.init,
        kmeans_iters=args.kmeans_iters, restarts=args.restarts,
        cc_iters=args.cc_iters, edges=args.edges, knn_k=args.knn_k,
        aggregator=args.aggregator, trim_beta=args.trim_beta,
        seed=args.seed, method=args.method, rounds=args.rounds,
        trace=args.trace, route_probes=args.route_probes,
        finalize_repeats=args.finalize_repeats,
        reupload_frac=args.reupload_frac, churn=args.churn,
        max_age=args.max_age, refinalize_threshold=args.refinalize_threshold,
        qps_callers=args.qps_callers, qps_duration=args.qps_duration,
        device=args.device)
    ph = summary["phases"]
    print(f"[simulate] C={summary['clients']} K={summary['clusters']} "
          f"task={summary['task']} wave={summary['wave']} "
          f"algo={summary['algorithm']} shards={summary['shards']} "
          f"edges={summary['edges'] or '-'} "
          f"scenario={summary['scenario'] or '-'} "
          f"agg={summary['aggregator']} method={summary['method']} "
          f"rounds={summary['comm_rounds']:g} "
          f"device={summary['device_name']}")
    print(f"[simulate] local ERMs {ph['local_erm_s']:.3f}s  ingest "
          f"{ph['ingest_s']:.3f}s  server round {ph['aggregate_s']:.3f}s")
    clb = summary["comm_level_bytes"]
    if clb is not None:
        print(f"[simulate] hierarchy: level0 {clb['level0'] / 1e6:.2f}MB "
              f"(client uploads)  level1 {clb['level1'] / 1e6:.4f}MB "
              f"(shard centers)")
    mse = summary["mse"]
    print(f"[simulate] recovered K'={summary['n_clusters_recovered']} "
          f"purity={summary['purity']:.3f} "
          f"(all={summary['purity_all']:.3f}, "
          f"honest={summary['honest_frac']:.3f}) "
          f"mse={'-' if mse is None else format(mse, '.3g')} "
          f"n_iter={summary['meta'].get('n_iter')} lam={summary['lam']} "
          f"comm={summary['comm_bytes'] / 1e6:.2f}MB")
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
    if sv is not None and sv.get("live_clients") is not None:
        rw = sv["refinalize_warm_p50_ms"]
        print(f"[simulate] mutation: live={sv['live_clients']} "
              f"evictions={sv['evictions']} drift(after)="
              f"{sv['drift_after_mutation']:.3f} refinalize="
              f"{'-' if sv['refinalize_fired'] is None else ('fired' if sv['refinalize_fired'] else 'held')} "
              f"warm p50={'-' if rw is None else format(rw, '.3f')}ms")
    qs = summary["qps_server"]
    if qs is not None:
        print(f"[simulate] qps: {qs['callers']} callers  direct "
              f"{qs['direct_qps']:.0f}/s  batched {qs['batched_qps']:.0f}/s "
              f"p50={qs['batched_p50_ms']:.3f}ms "
              f"p99={qs['batched_p99_ms']:.3f}ms")
    if args.trace:
        print(f"[simulate] trace -> {args.trace}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2)
        print(f"[simulate] wrote {args.out}")
    return summary


if __name__ == "__main__":
    main()
