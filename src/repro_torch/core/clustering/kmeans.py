"""K-means seeding (the port of ``repro/core/clustering/kmeans.py``):
kmeans++ D^2 sampling through the ``pairwise_sqdist`` kernel, and the
uniform ``random`` init.  Draws come from an explicit
``torch.Generator`` on the points' device.  Spectral seeding and the
host Lloyd loop come later."""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops


def kmeans_plus_plus_init(generator: torch.Generator, points: torch.Tensor,
                          k: int) -> torch.Tensor:
    """K-means++ seeding [Arthur & Vassilvitskii 2007] (ODCL-KM++).

    As in the reference, every step measures all k center slots with one
    (m, k) ``pairwise_sqdist`` call and masks the slots not chosen yet,
    so seeding makes k - 1 kernel launches at the main path's shape."""
    m, d = points.shape
    dev = points.device
    first = torch.randint(m, (1,), generator=generator, device=dev)
    centers = torch.zeros((k, d), dtype=torch.float32, device=dev)
    centers[0:1] = points[first]
    slots = torch.arange(k, device=dev)
    for i in range(1, k):
        d2 = kops.pairwise_sqdist(points, centers)               # (m, k)
        d2 = d2.masked_fill((slots >= i)[None, :], float("inf"))
        mind = torch.min(d2, dim=1).values
        probs = mind / torch.clamp_min(torch.sum(mind), 1e-30)
        nxt = torch.multinomial(probs + 1e-30, 1, generator=generator)
        centers[i:i + 1] = points[nxt]
    return centers


def random_init(generator: torch.Generator, points: torch.Tensor,
                k: int) -> torch.Tensor:
    """k distinct rows drawn uniformly (the ``kmeans`` / ``random`` init)."""
    m = points.shape[0]
    if k > m:
        raise ValueError(f"random init needs k <= m, got k={k}, m={m}")
    sel = torch.randperm(m, generator=generator, device=points.device)[:k]
    return points[sel].to(torch.float32)
