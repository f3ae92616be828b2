"""The one-shot round (Algorithm 1, server side) on the port's device
(the port of ``repro/core/engine/aggregate.py``):

    sketch every client's parameters (JL projection)
    -> cluster the (C, sketch_dim) sketches (``kmeans-device``)
    -> per-cluster parameter mean, gathered back per client

Sketches, centers and averaged parameters stay on the device; the host
gets the compacted labels and the scalar meta.  The session's finalize
runs the same stages as two programs (cluster, then mean) and its
``route`` runs the route program.  A ``_Program`` is a plain callable
that times each call under the reference's span name
(``<label>.execute``) and synchronizes its stream once at its end;
PyTorch runs eagerly, so there is nothing to compile.

Under a mesh (``mesh=`` / ``client_axis=``, ``sharding/clients.py``) each
rank holds a block of the clients: it sketches its own rows (every rank
draws the same projection blocks from ``seed``, so a client's sketch row
does not depend on the sharding), the clustering runs per shard with
all-reduced sums (``kmeans-device``) or on the gathered sketch (the
other families), and the mean phase all-reduces per-cluster sums and
counts into (K, ...) representatives on every rank, from which each rank
writes its own clients' rows: the per-client parameters come back as
``DTensor``s, ``Shard(0)`` on the client dim, the labels for every
client on every rank.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.clustering.api import (
    get_algorithm,
    is_device_algorithm,
    meta_to_host,
)
from repro_torch.core.engine.aggregators import cluster_reps, get_aggregator
from repro_torch.core.federated import FederatedState, _leaf_filter_for
from repro_torch.core.sketch import make_generator, sketch_stacked
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.roofline import kernel_costs
from repro_torch.sharding.clients import client_axis_of
from repro_torch.utils import tree_leaves, tree_map


def weighted_reps(labels, kk: int, params, weights, shard, then=None):
    """The exp-decay staleness policy's step 3: (K, ...) representatives
    ``sum_i w_i x_i / sum_i w_i`` from this rank's rows, the sums and the
    denominator (floored at 1e-12) all-reduced.  Only the mean has a
    weighted form; the session refuses weighting for any other
    aggregator.  ``then`` as in :func:`cluster_reps`."""
    onehot = torch.nn.functional.one_hot(labels.long(), kk).to(torch.float32)
    weighted = onehot * weights.to(torch.float32)[:, None]
    denom = torch.clamp_min(shard.all_reduce(torch.sum(weighted, dim=0)),
                            1e-12)[:, None]

    def rep(leaf):
        flat = leaf.reshape(leaf.shape[0], math.prod(leaf.shape[1:])).to(
            torch.float32)
        means = shard.all_reduce(weighted.T @ flat) / denom
        out = means.reshape((kk,) + tuple(leaf.shape[1:])).to(leaf.dtype)
        return out if then is None else then(out)

    return tree_map(rep, params)


class _Program:
    """A named stage of the round: each call runs under the
    ``"<label>.execute"`` span and ends by synchronizing the calling
    thread's current stream when its outputs are still on a CUDA device
    (a stage that already copied its outputs to the host has
    synchronized by then).  The wait is local to that stream, so a round
    computed on a worker's stream and routes on another thread's stream
    do not wait for each other.

    Each call also sets the ``"<label>.flops"`` and ``"<label>.bytes"``
    gauges to the call's work, counted from shapes: every engine kernel
    call it made (charged at ``kernels/ops.py``'s dispatch, so the
    iterations that actually ran count, on the card and the CPU alike)
    plus ``work(out, *args) -> (bytes, ops)``, the stage's own PyTorch
    work where it has a stated term (the one-hot mean, the gather, the
    route's distances, the sketch)."""

    def __init__(self, label: str, fn, work=None):
        self.label = label
        self._fn = fn
        self._work = work

    def __call__(self, *args):
        with obs.span(f"{self.label}.execute"):
            with kernel_costs.tally() as spent:
                out = self._fn(*args)
            cuda = [t for t in tree_leaves(out)
                    if isinstance(t, torch.Tensor) and t.is_cuda]
            if cuda:
                torch.cuda.current_stream(cuda[0].device).synchronize()
            own = self._work(out, *args) if self._work else (0.0, 0.0)
            obs.gauge(f"{self.label}.flops", spent.ops + own[1])
            obs.gauge(f"{self.label}.bytes", spent.bytes + own[0])
        return out


def _mean_work(out, labels, centers, params, *_):
    """The one-hot mean of every leaf (C, n): the (K, C) x (C, n)
    product and its (C, K) x (K, n) gather back, 4 C K n flops; the
    leaves read and written once and the one-hot read.  Under a mesh C
    is this rank's rows."""
    leaves = tree_leaves(params)
    c, kk = leaves[0].shape[0], centers.shape[0]
    n = sum(math.prod(l.shape[1:]) for l in leaves)
    nbytes = sum(2 * l.numel() * l.element_size() for l in leaves)
    return nbytes + 4.0 * c * kk, 4.0 * c * kk * n


def _gather_work(out, buf, rows):
    """The live rows of every leaf read and written, and their indices
    read (int64); no arithmetic."""
    moved = sum(2 * rows.numel() * math.prod(l.shape[1:])
                * l.element_size() for l in tree_leaves(buf))
    return moved + 8.0 * rows.numel(), 0.0


def _route_work(out, pts, centers):
    """The batch's d^2 to its centers: the points and the gathered
    centers read (fp32), 3 flops an element (difference, square, sum)."""
    m, d = pts.shape
    return 8.0 * m * d, 3.0 * m * d


def _round_work(out, params):
    """The fused round's own work: the JL sketch, a (C, n) x (n, s)
    product with C n and n s read and C s written, 2 C n s flops, and
    the one-hot mean (:func:`_mean_work`)."""
    _, res, sketches = out
    c, s = sketches.shape
    n = sum(math.prod(l.shape[1:]) for l in tree_leaves(params))
    mean_bytes, mean_flops = _mean_work(None, None, res.centers, params)
    return (4.0 * (c * n + n * s + c * s) + mean_bytes,
            2.0 * c * n * s + mean_flops)


def _cluster_program(algo, k, options):
    """Step 2 alone: the session finalize's clustering phase over the
    sketch rows of ``shard``."""
    options = dict(options or {})

    def cluster_fn(generator, sketches, shard):
        return algo.device_call(generator, sketches, k=k, shard=shard,
                                **options)

    return _Program("session.finalize.cluster", cluster_fn)


def _average(labels, kk: int, params, aggregator, shard, weights=None,
             keep_reps: bool = True):
    """Steps 3-4: the (K, ...) representatives (K = ``kk``) from this
    rank's rows (``cluster_reps``, or ``weighted_reps`` with per-client
    weights), then each client's row from its cluster's (``expand``: this
    rank's ``Shard(0)`` chunk under a mesh).  ``labels`` are every
    client's.  Returns ``(per-client params, representatives)``; with
    ``keep_reps=False`` each leaf's representatives are dropped once its
    rows are written (``None`` in their place: a round that hands back
    only the per-client rows holds one leaf's at a time)."""
    mine = shard.local_part(labels)

    def reps(then=None):
        if weights is None:
            return cluster_reps(mine, kk, params, aggregator, shard, then)
        return weighted_reps(mine, kk, params, weights, shard, then)

    def expand(r):
        return shard.axis.expand(r, labels)

    if not keep_reps:
        return reps(expand), None
    table = reps()
    return tree_map(expand, table), table


def _mean_program(aggregator="mean"):
    """Steps 3-4 alone: the session finalize's averaging phase."""

    def mean_fn(labels, centers, params, shard, weights=None):
        return _average(labels, centers.shape[0], params, aggregator, shard,
                        weights)

    return _Program("session.finalize.mean", mean_fn, _mean_work)


def _warm_cluster_program(algo, k, options):
    """Step 2 warm-started: the session's incremental re-finalize runs the
    family's ``device_warm_call`` from the previous round's state (the
    centers for Lloyd, the AMA dual for the convex family)."""
    options = dict(options or {})

    def cluster_fn(generator, sketches, warm, shard):
        return algo.device_warm_call(generator, sketches, warm, k=k,
                                     shard=shard, **options)

    return _Program("session.refinalize.cluster", cluster_fn)


def _gather_rows_program():
    """Live-row gather: compact a holey fixed-capacity buffer (the
    sketches and the stacked parameter tree) down to the surviving rows.
    A session whose live rows are a contiguous prefix takes a slice
    instead."""

    def gather_fn(buf, rows):
        return tree_map(lambda l: l.index_select(0, rows), buf)

    return _Program("session.gather", gather_fn, _gather_work)


def _route_program():
    """Serving-time step 4 over a request batch: the fused nearest-center
    assignment plus the batch's total d^2 to its assigned centers, brought
    to the host in ONE transfer (the labels and the d^2 bits ride one
    int32 tensor).  Returns ``(labels (n,) int32 numpy, d2 float)``."""

    def route_fn(pts, centers):
        labels, _, _ = kops.kmeans_assign(pts, centers)
        d2 = torch.sum((pts - centers[labels.long()]) ** 2)
        packed = torch.cat([labels, d2.reshape(1).view(torch.int32)]).cpu()
        host = packed.numpy()
        return host[:-1].copy(), float(host[-1:].view(np.float32)[0])

    return _Program("session.route.batch", route_fn, _route_work)


def resolve_device_algorithm(algorithm):
    algo = get_algorithm(algorithm)
    if not is_device_algorithm(algo):
        raise ValueError(f"algorithm {getattr(algo, 'name', algo)!r} is not "
                         "a device clustering algorithm")
    return algo


def compact_labels(raw_labels):
    """Label compaction: device clusterings may leave empty Lloyd
    clusters.  Returns numpy ``(labels in [0, K'), uniq raw ids, first
    index per compact id)``, the same triple as the reference's
    ``np.unique(..., return_index=True, return_inverse=True)``, computed
    on the labels' device in O(m) (no sort) and brought to the host in
    one transfer."""
    raw = torch.as_tensor(raw_labels).long()
    m = raw.shape[0]
    counts = torch.bincount(raw)
    present = counts > 0
    remap = torch.cumsum(present, 0) - 1
    first = torch.full_like(counts, m).scatter_reduce_(
        0, raw, torch.arange(m, device=raw.device), reduce="amin")
    uniq = torch.nonzero(present).flatten()
    packed = torch.cat([remap[raw], uniq, first[uniq]]).to(torch.int32)
    host = packed.cpu().numpy()
    n = uniq.numel()
    return host[:m].copy(), host[m:m + n].copy(), host[m + n:].copy()


def materialize_round(new_params, res, state: FederatedState):
    """Host materialization of a round: compacted labels and scalar meta
    are the only transfers; params stay on the device.  Returns
    ``(new_state, labels, info, uniq, first)``."""
    labels, uniq, first = compact_labels(res.labels)
    new_state = FederatedState(params=new_params, opt_state=None,
                               n_clients=state.n_clients, step=state.step)
    info = {"n_clusters": int(len(uniq)), "meta": meta_to_host(res.meta),
            "engine": "device"}
    return new_state, labels, info, uniq, first


def one_shot_aggregate_device(state: FederatedState, cfg=None, *,
                              algorithm="kmeans-device",
                              k: Optional[int] = None,
                              algo_options: Optional[dict] = None,
                              sketch_dim: int = 256, seed: int = 0,
                              cluster_seed: Optional[int] = None,
                              aggregator="mean",
                              projection: Optional[torch.Tensor] = None,
                              return_sketches: bool = False,
                              mesh=None, client_axis: str = "data",
                              device=None):
    """The one-shot round on one device.  Returns (state, labels, info).

    ``seed`` draws the JL projection block by block as the sketch streams
    (or pass ``projection=``, an (n, sketch_dim) matrix);
    ``cluster_seed`` (default ``seed``) seeds the clustering's
    generator.  ``cfg`` (the clients' ``ModelConfig``) picks the
    router-invariant sketch of an MoE model.  Runs on CUDA unless
    ``device="cpu"``; the parameters are moved there.

    ``mesh`` (a ``DeviceMesh`` with a ``client_axis`` dim): rank r takes
    the r-th of equal blocks of the clients (a client count the ranks do
    not divide is refused), from each leaf's ``DTensor`` shard or from
    the global tensor every rank passes; the new parameters are
    ``Shard(0)`` DTensors and the labels cover every client."""
    dev = resolve_device(device)
    algo = resolve_device_algorithm(algorithm)
    aggregator = get_aggregator(aggregator)
    axis = client_axis_of(mesh, client_axis)
    shard = axis.even(state.n_clients)
    params = tree_map(lambda l: axis.local_rows(l, state.n_clients).to(dev),
                      state.params)
    generator = make_generator(seed if cluster_seed is None
                               else cluster_seed, dev)

    def round_fn(params):
        sketches = sketch_stacked(params, projection, sketch_dim=sketch_dim,
                                  seed=seed,
                                  leaf_filter=_leaf_filter_for(cfg))
        res = algo.device_call(generator, sketches, k=k, shard=shard,
                               **(algo_options or {}))
        new_params, _ = _average(res.labels, res.centers.shape[0], params,
                                 aggregator, shard, keep_reps=False)
        return new_params, res, sketches

    with obs.span("engine.one_shot"):
        new_params, res, sketches = _Program("engine.round", round_fn,
                                             _round_work)(params)
    new_state, labels, info, _, _ = materialize_round(new_params, res, state)
    if return_sketches:
        info["sketches"] = shard.gather(sketches).cpu().numpy()
    return new_state, labels, info
