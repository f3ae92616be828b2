"""Baselines of Section 5: oracle and naive references (a copy of
``repro/core/oracles.py``; numpy).

  * Oracle Averaging — average local ERMs within the *true* clusters
    (AVGM of [13] run per cluster; what ODCL matches when clustering
    succeeds).
  * Cluster Oracle   — centralized training on each true cluster's
    pooled data (solves (3)); order-optimal target O(1/(n |C_k|)).
  * Local ERM        — each user keeps its own local model.
  * Naive Averaging  — average all m models, oblivious to heterogeneity
    (AVGM of [13] run globally).
"""
from __future__ import annotations

import numpy as np


def oracle_averaging(local_models, true_labels):
    """(m,d) models, (m,) true labels -> per-user model (m,d)."""
    local_models = np.asarray(local_models, np.float32)
    true_labels = np.asarray(true_labels)
    out = np.empty_like(local_models)
    for k in np.unique(true_labels):
        out[true_labels == k] = local_models[true_labels == k].mean(axis=0)
    return out


def naive_averaging(local_models):
    local_models = np.asarray(local_models, np.float32)
    return np.broadcast_to(local_models.mean(axis=0), local_models.shape).copy()


def local_erm(local_models):
    return np.asarray(local_models, np.float32).copy()


def cluster_oracle(solve_fn, xs, ys, true_labels):
    """Pool each true cluster's data and solve centrally.

    solve_fn(x, y) -> theta. xs/ys are per-user arrays with leading axis m.
    Returns per-user models (m, d).
    """
    xs, ys = np.asarray(xs), np.asarray(ys)
    true_labels = np.asarray(true_labels)
    models = {}
    for k in np.unique(true_labels):
        sel = true_labels == k
        x = xs[sel].reshape(-1, xs.shape[-1])
        y = ys[sel].reshape(-1)
        models[k] = np.asarray(solve_fn(x, y))
    return np.stack([models[k] for k in true_labels])
