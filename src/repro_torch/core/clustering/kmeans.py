"""K-means clustering, Lloyd's algorithm with its three seedings (the port
of ``repro/core/clustering/kmeans.py``): kmeans++ D^2 sampling, the
uniform ``random`` init, spectral seeding, and the host Lloyd loop of
ODCL-KM (paper Section 3, Appendix B.2.2).

Every distance goes through ``kops.pairwise_sqdist`` (the CUDA kernel on
a card, its plain version on the CPU).  Draws come from an explicit
``torch.Generator`` on the points' device; the rows of the ``random``
init come from a row sampler (``randperm_rows`` by default), through
which the parity tests hand the reference's rows in.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.sharding.clients import shard_of


class KMeansResult(NamedTuple):
    labels: torch.Tensor     # (m,) int32 cluster assignment
    centers: torch.Tensor    # (k, d) cluster centers
    inertia: torch.Tensor    # () sum of squared distances to the center
    n_iter: int              # iterations actually run


def randperm_rows(generator: torch.Generator, m: int, n: int) -> torch.Tensor:
    """n distinct rows of m, uniformly: the default row sampler."""
    return torch.randperm(m, generator=generator,
                          device=generator.device)[:n]


def _assign(points, centers):
    """Nearest-center assignment via the pairwise-distance kernel: labels
    (ties to the lowest index) and each row's squared distance."""
    d2 = kops.pairwise_sqdist(points, centers)            # (m, k)
    mind, labels = torch.min(d2, dim=1)
    return labels.to(torch.int32), mind


def _update_centers(points, labels, k: int, prev_centers):
    """Mean of assigned points; empty clusters keep their previous center."""
    onehot = torch.nn.functional.one_hot(labels.long(), k).to(points.dtype)
    counts = torch.sum(onehot, dim=0)                     # (k,)
    sums = onehot.T @ points                              # (k, d)
    means = sums / torch.clamp_min(counts, 1.0)[:, None]
    return torch.where(counts[:, None] > 0, means, prev_centers), counts


def kmeans_plus_plus_init(generator: torch.Generator, points: torch.Tensor,
                          k: int, shard=None) -> torch.Tensor:
    """K-means++ seeding [Arthur & Vassilvitskii 2007] (ODCL-KM++).

    As in the reference, every step measures all k center slots with one
    (m, k) ``pairwise_sqdist`` call and masks the slots not chosen yet,
    so seeding makes k - 1 kernel launches at the main path's shape.

    ``shard`` (a ``sharding.clients.RowShard``): ``points`` are this
    rank's rows.  Each step gathers the (m,) min-d^2 vector and every
    rank draws with the same call on the same generator, so the seeds
    are the unsharded run's; the owner's row reaches every rank."""
    shard = shard_of(points, shard)
    dev = points.device
    first = torch.randint(shard.total, (1,), generator=generator, device=dev)
    centers = torch.zeros((k, points.shape[1]), dtype=torch.float32,
                          device=dev)
    centers[0:1] = shard.take_rows(points, first)
    slots = torch.arange(k, device=dev)
    for i in range(1, k):
        d2 = kops.pairwise_sqdist(points, centers)               # (m, k)
        d2 = d2.masked_fill((slots >= i)[None, :], float("inf"))
        mind = shard.gather(torch.min(d2, dim=1).values)
        probs = mind / torch.clamp_min(torch.sum(mind), 1e-30)
        nxt = torch.multinomial(probs + 1e-30, 1, generator=generator)
        centers[i:i + 1] = shard.take_rows(points, nxt)
    return centers


def random_init(generator: torch.Generator, points: torch.Tensor, k: int,
                sampler=randperm_rows, shard=None) -> torch.Tensor:
    """k distinct rows drawn uniformly (the ``kmeans`` / ``random`` init);
    under a ``shard`` the global rows, from their owners."""
    shard = shard_of(points, shard)
    m = shard.total
    if k > m:
        raise ValueError(f"random init needs k <= m, got k={k}, m={m}")
    sel = sampler(generator, m, k).to(points.device)
    return shard.take_rows(points, sel).to(torch.float32)


def top_right_singular(x: torch.Tensor, k: int, shard=None) -> torch.Tensor:
    """The top-k right singular vectors of a tall (m, d) matrix, (k, d),
    as the SVD of the (d, d) triangle of its QR (the same subspace as the
    SVD of x itself, without a bidiagonalization of m rows).  Over the
    ranks of a ``shard``, a TSQR: each rank's triangle, then one QR of
    the stacked triangles (one rank's triangle is already the one)."""
    shard = shard_of(x, shard)
    r = torch.linalg.qr(x, mode="r")[1]
    if len(shard.sizes) > 1:
        d = x.shape[1]
        stacked = shard.axis.gather(r, [min(s, d) for s in shard.sizes])
        r = torch.linalg.qr(stacked, mode="r")[1]
    return torch.linalg.svd(r, full_matrices=False)[2][:k]


def spectral_init(points: torch.Tensor, k: int, shard=None) -> torch.Tensor:
    """SVD-space initialization (Awasthi-Sheffet style, Appendix B.2.2).

    Project the mean-centered points onto the top-k right singular
    subspace and run a greedy farthest-point seeding there, its distances
    from ``pairwise_sqdist`` in the projected space (m, k) x (k, k);
    return the seeds in the original space.  Under a ``shard`` the
    distances run per shard and each argmax reads the gathered (m,)
    vector."""
    points = points.to(torch.float32)
    shard = shard_of(points, shard)
    mean = shard.all_reduce(torch.sum(points, dim=0, keepdim=True))
    x = points - mean / shard.total
    proj = x @ top_right_singular(x, k, shard).T          # (m, k)
    dev = points.device
    idxs = torch.zeros(k, dtype=torch.long, device=dev)
    idxs[0] = torch.argmax(shard.gather(torch.sum(proj * proj, dim=1)))
    chosen = torch.zeros((k, proj.shape[1]), dtype=torch.float32, device=dev)
    chosen[0:1] = shard.take_rows(proj, idxs[0:1])
    slots = torch.arange(k, device=dev)
    for i in range(1, k):
        d2 = kops.pairwise_sqdist(proj, chosen)           # (m, k)
        d2 = d2.masked_fill((slots >= i)[None, :], float("inf"))
        idxs[i] = torch.argmax(shard.gather(torch.min(d2, dim=1).values))
        chosen[i:i + 1] = shard.take_rows(proj, idxs[i:i + 1])
    return shard.take_rows(points, idxs)


def init_centers(generator, points, k: int, init: str,
                 sampler=randperm_rows, shard=None) -> torch.Tensor:
    """The seeding ``init`` names: ``kmeans++`` | ``spectral`` | ``random``."""
    if init == "kmeans++":
        return kmeans_plus_plus_init(generator, points, k, shard)
    if init == "spectral":
        return spectral_init(points, k, shard)
    if init == "random":
        return random_init(generator, points, k, sampler, shard)
    raise ValueError(f"unknown init {init!r}")


def kmeans(generator: torch.Generator, points: torch.Tensor, k: int,
           iters: int = 50, init: str = "kmeans++", tol: float = 1e-8,
           sampler=None) -> KMeansResult:
    """Lloyd's algorithm on the pairwise-distance kernel (the host loop).

    The reference's early-freeze rule: the loop stops at the first
    iteration whose largest squared center move is below ``tol`` (that
    iteration counts in ``n_iter``).  Inertia is the sum of the final
    assignment's row minima.  ``sampler(generator, m, n)`` draws the
    random init's rows."""
    points = points.to(torch.float32)
    centers = init_centers(generator, points, k, init,
                           randperm_rows if sampler is None else sampler)
    n_iter = 0
    for _ in range(iters):
        labels, _ = _assign(points, centers)
        new_centers, _ = _update_centers(points, labels, k, centers)
        moved = torch.max(torch.sum((new_centers - centers) ** 2, dim=1))
        centers = new_centers
        n_iter += 1
        if bool(moved < tol):
            break
    labels, mind = _assign(points, centers)
    return KMeansResult(labels=labels, centers=centers,
                        inertia=torch.sum(mind), n_iter=n_iter)
