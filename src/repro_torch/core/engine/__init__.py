"""The device aggregation engine: Algorithm 1's server steps 2-4 with no
host round trip (the port of ``repro/core/engine``).

  step 2  ``device_kmeans.py``: the Lloyd loop over the hand-written
          ``kmeans_assign`` kernel (kmeans++ seeding over
          ``pairwise_sqdist``), with restarts, minibatch and robust
          center updates; ``device_convex.py``: the AMA fixed point over
          the ``group_prox`` kernels on an ``edges.py`` fusion graph
          (``complete`` | ``knn`` | ``knn-approx``, a registry).
  step 3  ``aggregators.py``: the per-cluster reduction (``mean`` |
          ``trimmed_mean`` | ``median`` | ``geometric_median``, a
          registry); ``staleness.py`` weights or drops old uploads.
  step 4  the gather-back of each cluster's model to its clients.

``aggregate.py`` runs them as one round (``one_shot_aggregate_device``);
``session.py``'s ``AggregationSession`` is the streaming server (ingest
waves, finalize, route never-seen clients) and ``hierarchy.py`` its
two-level, sharded form.  Those four names load lazily: they import
``core/federated.py``, which would close an import cycle through
``clustering/api.py`` and slow light imports.
"""
from repro_torch.core.engine.aggregators import (
    Aggregator,
    GeometricMedianAggregator,
    MeanAggregator,
    MedianAggregator,
    TrimmedMeanAggregator,
    cluster_aggregate_tree,
    cluster_reduce_tree,
    get_aggregator,
    list_aggregators,
    make_aggregator,
    register_aggregator,
    unregister_aggregator,
)
from repro_torch.core.engine.device_convex import (
    DeviceConvexResult,
    device_clusterpath,
    device_convex_cluster,
)
from repro_torch.core.engine.device_kmeans import (
    DeviceKMeansResult,
    device_kmeans,
)
from repro_torch.core.engine.edges import (
    ApproxKnnEdges,
    CompleteEdges,
    Edges,
    EdgeSet,
    KnnEdges,
    get_edge_set,
    list_edge_sets,
    register_edge_set,
    unregister_edge_set,
)
from repro_torch.core.engine.staleness import (
    ExpDecay,
    NoStaleness,
    SlidingWindow,
    make_staleness_policy,
)

__all__ = [
    "AggregationSession",
    "Aggregator",
    "ApproxKnnEdges",
    "CompleteEdges",
    "HierarchicalSession",
    "hierarchical_one_shot_aggregate",
    "DeviceConvexResult",
    "DeviceKMeansResult",
    "Edges",
    "EdgeSet",
    "ExpDecay",
    "GeometricMedianAggregator",
    "KnnEdges",
    "MeanAggregator",
    "MedianAggregator",
    "NoStaleness",
    "SlidingWindow",
    "TrimmedMeanAggregator",
    "make_staleness_policy",
    "cluster_aggregate_tree",
    "cluster_reduce_tree",
    "device_clusterpath",
    "device_convex_cluster",
    "device_kmeans",
    "get_aggregator",
    "get_edge_set",
    "list_aggregators",
    "list_edge_sets",
    "make_aggregator",
    "one_shot_aggregate_device",
    "register_aggregator",
    "register_edge_set",
    "unregister_aggregator",
    "unregister_edge_set",
]

_LAZY = {
    "one_shot_aggregate_device": "repro_torch.core.engine.aggregate",
    "AggregationSession": "repro_torch.core.engine.session",
    "HierarchicalSession": "repro_torch.core.engine.hierarchy",
    "hierarchical_one_shot_aggregate": "repro_torch.core.engine.hierarchy",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
