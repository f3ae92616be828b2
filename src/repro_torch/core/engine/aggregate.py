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
(``<label>.execute``) and synchronizes the device once at its end;
PyTorch runs eagerly, so there is nothing to compile.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.clustering.api import (
    get_algorithm,
    is_device_algorithm,
    meta_to_host,
)
from repro_torch.core.engine.aggregators import (
    cluster_aggregate_tree,
    get_aggregator,
)
from repro_torch.core.federated import FederatedState
from repro_torch.core.sketch import jl_projection, make_generator, sketch_stacked
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.utils import tree_leaves, tree_map, tree_size


def _average_clusters(labels, centers, params, aggregator):
    """Steps 3-4: the per-cluster parameter reduction, shared by the
    fused round and the session's mean phase."""
    kk = centers.shape[0]
    onehot = torch.nn.functional.one_hot(labels.long(), kk).to(torch.float32)
    counts = torch.sum(onehot, dim=0)
    return cluster_aggregate_tree(params, labels, onehot, counts, aggregator)


def _cluster_and_average(algo, options, k, generator, sketches, params,
                         aggregator="mean"):
    """Steps 2-4 on a materialized sketch matrix."""
    res = algo.device_call(generator, sketches, k=k, **options)
    return _average_clusters(res.labels, res.centers, params, aggregator), res


class _Program:
    """A named stage of the round: each call runs under the
    ``"<label>.execute"`` span and ends with one device synchronize when
    its outputs are still on a CUDA device (a stage that already copied
    its outputs to the host has synchronized by then)."""

    def __init__(self, label: str, fn):
        self.label = label
        self._fn = fn

    def __call__(self, *args):
        with obs.span(f"{self.label}.execute"):
            out = self._fn(*args)
            cuda = [t for t in tree_leaves(out)
                    if isinstance(t, torch.Tensor) and t.is_cuda]
            if cuda:
                torch.cuda.synchronize(cuda[0].device)
        return out


def _cluster_program(algo, k, options):
    """Step 2 alone: the session finalize's clustering phase."""
    options = dict(options or {})

    def cluster_fn(generator, sketches):
        return algo.device_call(generator, sketches, k=k, **options)

    return _Program("session.finalize.cluster", cluster_fn)


def _mean_program(aggregator="mean"):
    """Steps 3-4 alone: the session finalize's averaging phase."""

    def mean_fn(labels, centers, params):
        return _average_clusters(labels, centers, params, aggregator)

    return _Program("session.finalize.mean", mean_fn)


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

    return _Program("session.route.batch", route_fn)


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


def one_shot_aggregate_device(state: FederatedState, *,
                              algorithm="kmeans-device",
                              k: Optional[int] = None,
                              algo_options: Optional[dict] = None,
                              sketch_dim: int = 256, seed: int = 0,
                              cluster_seed: Optional[int] = None,
                              aggregator="mean",
                              projection: Optional[torch.Tensor] = None,
                              return_sketches: bool = False,
                              device=None):
    """The one-shot round on one device.  Returns (state, labels, info).

    ``seed`` draws the JL projection (or pass ``projection=`` (n,
    sketch_dim) explicitly); ``cluster_seed`` (default ``seed``) seeds the
    clustering's generator.  Runs on CUDA unless ``device="cpu"``; the
    parameters are moved there."""
    dev = resolve_device(device)
    algo = resolve_device_algorithm(algorithm)
    aggregator = get_aggregator(aggregator)
    params = tree_map(lambda l: torch.as_tensor(l).to(dev), state.params)
    if projection is None:
        n = tree_size(params) // state.n_clients
        projection = jl_projection(n, sketch_dim, seed=seed, device=dev)
    projection = projection.to(dev, torch.float32)
    generator = make_generator(seed if cluster_seed is None
                               else cluster_seed, dev)

    def round_fn(params):
        sketches = sketch_stacked(params, projection)
        new_params, res = _cluster_and_average(
            algo, algo_options or {}, k, generator, sketches, params,
            aggregator)
        return new_params, res, sketches

    with obs.span("engine.one_shot"):
        new_params, res, sketches = _Program("engine.round", round_fn)(params)
    new_state, labels, info, _, _ = materialize_round(new_params, res, state)
    if return_sketches:
        info["sketches"] = sketches.cpu().numpy()
    return new_state, labels, info
