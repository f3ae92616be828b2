"""Algorithm 1, the ODCL-C one-shot protocol, on an (m, d) stack of model
vectors (the port's subset of ``repro/core/odcl.py``: ``run_clustering``,
``aggregate`` and ``odcl``, on which the session's ``engine="host"``
round is built):

    1. every user solves its local ERM and uploads theta_hat_i  (1 round)
    2. the server clusters {theta_hat_i} with an admissible algorithm
    3. the server averages models within each recovered cluster
    4. each user receives its cluster's averaged model

Step 2 goes through the admissible-clustering registry and step 3
through the aggregator registry.  A tensor is used on its device;
anything else goes to ``device`` (CUDA unless "cpu").
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.clustering.admissible import separability_alpha
from repro_torch.core.clustering.api import ClusteringResult, get_algorithm
from repro_torch.core.engine.aggregators import cluster_reps
from repro_torch.core.sketch import make_generator
from repro_torch.device import resolve_device


@dataclasses.dataclass
class ODCLResult:
    labels: np.ndarray               # (m,) recovered cluster of each user
    cluster_models: np.ndarray       # (K', d) averaged model per cluster
    user_models: np.ndarray          # (m, d) model each user receives
    n_clusters: int
    meta: dict


def _as_points(points, device=None) -> torch.Tensor:
    if not isinstance(points, torch.Tensor):
        points = torch.as_tensor(np.asarray(points, np.float32)).to(
            resolve_device(device))
    return points.to(torch.float32)


def run_clustering(generator, points, algorithm, *, k: Optional[int] = None,
                   assert_separable: bool = False, device=None,
                   **options) -> ClusteringResult:
    """Step 2 through the registry, with Definition-1 reporting: the
    achieved separability margin (condition (4)) and the algorithm's
    Lemma-1/2 admissibility margin go into ``result.meta``.  With
    ``assert_separable=True`` a clustering whose achieved margin is at or
    below the admissible one raises ``ValueError``."""
    algo = get_algorithm(algorithm)
    pts = _as_points(points, device)
    result = algo(generator, pts, k=k, **options)
    m = int(pts.shape[0])
    counts = np.bincount(result.labels, minlength=result.n_clusters)
    c_min = int(counts[counts > 0].min()) if m else 0
    achieved = separability_alpha(pts, result.labels)
    admissible = float(algo.admissibility_alpha(m, max(c_min, 1)))
    meta = dict(result.meta)
    meta["separability_alpha"] = float(achieved)
    meta["admissible_alpha"] = admissible
    if assert_separable and not achieved > admissible:
        raise ValueError(
            f"clustering by {algo.name!r} is not separable per Definition 1: "
            f"achieved alpha {achieved:.3g} <= admissible {admissible:.3g}")
    return dataclasses.replace(result, meta=meta)


def aggregate(local_models, labels, aggregator="mean", device=None):
    """Steps 3-4: the per-cluster reduction through the aggregator
    registry and each user's model.  Returns numpy ``(cluster_models
    (K', d), user_models (m, d))``."""
    local = _as_points(local_models, device)
    labels = np.asarray(labels)
    n_clusters = int(labels.max()) + 1
    labels_t = torch.as_tensor(labels, dtype=torch.int32, device=local.device)
    cluster_avg = cluster_reps(labels_t, n_clusters, local,
                               aggregator).cpu().numpy()
    return cluster_avg, cluster_avg[labels]


def odcl(local_models, *, algorithm="kmeans++", k: Optional[int] = None,
         seed: int = 0, assert_separable: bool = False, aggregator="mean",
         device=None, **options) -> ODCLResult:
    """The server side of Algorithm 1 on an (m, d) model stack; keyword
    ``options`` go to the clustering algorithm (``iters=``, ``lam=``...).
    ``seed`` seeds the clustering's generator on the models' device."""
    local = _as_points(local_models, device)
    result = run_clustering(make_generator(seed, local.device), local,
                            algorithm, k=k,
                            assert_separable=assert_separable, **options)
    cluster_avg, user_models = aggregate(local, result.labels,
                                         aggregator=aggregator)
    return ODCLResult(labels=result.labels, cluster_models=cluster_avg,
                      user_models=user_models,
                      n_clusters=cluster_avg.shape[0], meta=result.meta)
