"""Separability condition (4) and admissibility constants (Lemmas 1-2).

Definition 1: a dataset {a_i} is separable wrt clustering {C_k} with
margin alpha if  alpha * ||mu_k - a_i|| < ||mu_k - mu_l||  for all
i in C_k, k != l.

Lemma 1 (ODCL-CC):  admissible when alpha = 4 (m - |C_(K)|) / |C_(K)|.
Lemma 2 (ODCL-KM):  admissible when alpha = 2 + 2 c sqrt(m) / |C_(K)|.

The port's copy of ``repro/core/clustering/admissible.py``.  The margin
is computed in float64 as there, on the points' device when they are a
tensor (a session's sketches stay on the card), on the CPU otherwise.
"""
from __future__ import annotations

import numpy as np
import torch


def _stats(points, labels):
    points = torch.as_tensor(points).to(torch.float64)
    labels = torch.as_tensor(labels).to(points.device).long()
    ks, inv = torch.unique(labels, return_inverse=True)
    n = ks.numel()
    counts = torch.bincount(inv, minlength=n).to(torch.float64)
    mus = torch.zeros((n, points.shape[1]), dtype=torch.float64,
                      device=points.device).index_add_(0, inv, points)
    mus = mus / counts[:, None]
    dist = torch.linalg.vector_norm(points - mus[inv], dim=1)
    radii = torch.zeros(n, dtype=torch.float64, device=points.device)
    radii = radii.scatter_reduce(0, inv, dist, reduce="amax")
    if n == 1:
        min_sep = float("inf")
    else:
        d = torch.linalg.vector_norm(mus[:, None] - mus[None, :], dim=-1)
        d.fill_diagonal_(float("inf"))
        min_sep = float(d.min())
    return mus, radii, min_sep


def separability_alpha(points, labels) -> float:
    """Largest alpha for which condition (4) holds (inf if radii are 0)."""
    _, radii, min_sep = _stats(points, labels)
    rmax = float(radii.max())
    if rmax == 0.0:
        return np.inf
    return float(min_sep / rmax)


def is_separable(points, labels, alpha: float) -> bool:
    """Check condition (4) for a given margin alpha."""
    return separability_alpha(points, labels) > alpha


def alpha_convex_clustering(m: int, c_min: int) -> float:
    """Lemma 1 margin for convex clustering."""
    return 4.0 * (m - c_min) / c_min


def alpha_kmeans(m: int, c_min: int, c: float = 1.0) -> float:
    """Lemma 2 margin for K-means with spectral init (c = global const)."""
    return 2.0 + 2.0 * c * np.sqrt(m) / c_min
