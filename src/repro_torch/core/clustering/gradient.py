"""Gradient clustering [Armacki et al., ICML 2022], the third admissible
family (the port of ``repro/core/clustering/gradient.py``).

Alternates nearest-center assignment with a *gradient* step on the
quantization objective (instead of the exact mean update of Lloyd's):

    x_k <- x_k - alpha / max(|C_k|, 1) * sum_{i in C_k} (x_k - a_i)

which for alpha = 1 is Lloyd's update.  The loop (``gradient_steps``) is
split from its kmeans++ seeding so that it can start from given centers
(the parity tests start it from the reference's seeds).
"""
from __future__ import annotations

import torch

from repro_torch.core.clustering.kmeans import (
    KMeansResult,
    _assign,
    kmeans_plus_plus_init,
)


def gradient_steps(points: torch.Tensor, centers: torch.Tensor, *,
                   alpha: float = 0.5, iters: int = 100) -> KMeansResult:
    """``iters`` damped center steps from ``centers`` (k, d), then the
    final assignment."""
    points = points.to(torch.float32)
    centers = centers.to(torch.float32)
    k = centers.shape[0]
    for _ in range(iters):
        labels, _ = _assign(points, centers)
        onehot = torch.nn.functional.one_hot(labels.long(), k).to(
            torch.float32)
        counts = torch.sum(onehot, dim=0)                  # (k,)
        sums = onehot.T @ points                           # (k, d)
        # grad of 1/2 sum_i ||x_{c(i)} - a_i||^2 wrt x_k
        grad = counts[:, None] * centers - sums
        step = alpha / torch.clamp_min(counts, 1.0)[:, None]
        centers = centers - step * grad
    labels, mind = _assign(points, centers)
    return KMeansResult(labels=labels, centers=centers,
                        inertia=torch.sum(mind), n_iter=iters)


def gradient_clustering(generator: torch.Generator, points: torch.Tensor,
                        k: int, *, alpha: float = 0.5,
                        iters: int = 100) -> KMeansResult:
    """kmeans++ seeding, then ``iters`` damped steps."""
    points = points.to(torch.float32)
    centers = kmeans_plus_plus_init(generator, points, k)
    return gradient_steps(points, centers, alpha=alpha, iters=iters)
