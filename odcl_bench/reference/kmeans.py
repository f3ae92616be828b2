"""ODCL-KM's clustering step in plain PyTorch: kmeans++ seeding
(Arthur & Vassilvitskii 2007) and Lloyd's iterations until the largest
squared center move is below ``tol`` (that iteration counts), then the
final assignment.  Distances come from the expansion ||x||^2 + ||c||^2
- 2 x.c, one product a pass, so a lower precision of products shows.

The judge does not hold a round's partition to this: a seeding draws its
own rows, so two correct implementations part ways on the draws.  It
checks instead that a served partition is Lloyd's last assignment
(:func:`nearest`) to centers that are its means, and holds the seeding's quality over many rounds to
the best of a few draws of this (:func:`objective`).  This is what the
control runs in the program's place.
"""
from __future__ import annotations

import torch

from odcl_bench.reference import cluster_means, precision, rel_err

# a distance gap below this share of ||x||^2 + ||c||^2 is a tie: the
# expansion's fp32 rounding (a few ulp of the larger term) is far below
TIE = 1e-5


def sqdist(x: torch.Tensor, c: torch.Tensor, prec: str = "fp64"):
    """(m, k) squared distances of the rows of ``x`` to those of ``c``."""
    with precision(prec) as dtype:
        x, c = x.to(dtype), c.to(dtype)
        d2 = ((x * x).sum(dim=1)[:, None] + (c * c).sum(dim=1)[None, :]
              - 2.0 * (x @ c.T))
        return torch.clamp_min(d2, 0.0)


def nearest(x: torch.Tensor, c: torch.Tensor, prec: str = "fp64"):
    """Each row's nearest center (lowest index on a tie)."""
    return torch.argmin(sqdist(x, c, prec), dim=1)


def cluster(a: torch.Tensor, k: int, *, iters: int, tol: float,
            generator: torch.Generator, prec: str = "fp64") -> dict:
    """kmeans++ then Lloyd on the rows of ``a`` (m, s).  Returns
    ``labels`` (m,) in [0, K') (empty clusters dropped), ``centers``
    (K', s) and ``n_iter``."""
    with precision(prec) as dtype:
        a = a.to(dtype)
    m = a.shape[0]
    first = torch.randint(m, (1,), generator=generator,
                          device=generator.device).to(a.device)
    centers = a[first]
    for _ in range(1, k):
        d2 = sqdist(a, centers, prec).min(dim=1).values
        nxt = torch.multinomial((d2 / d2.sum()).float() + 1e-30, 1,
                                generator=generator).to(a.device)
        centers = torch.cat([centers, a[nxt]])
    n_iter = 0
    for _ in range(iters):
        labels = nearest(a, centers, prec)
        means, counts = cluster_means(a, labels, k, prec)
        new = torch.where(counts[:, None] > 0, means, centers)
        moved = float(((new - centers) ** 2).sum(dim=1).max())
        centers = new
        n_iter += 1
        if moved < tol:
            break
    raw = nearest(a, centers, prec)
    uniq, labels = torch.unique(raw, return_inverse=True)
    return {"labels": labels, "centers": centers[uniq], "n_iter": n_iter}


def judge(a: torch.Tensor, labels: torch.Tensor, centers: torch.Tensor,
          cfg: dict, lam=None, warm: bool = False) -> tuple:
    """ODCL-KM's partition against the fp64 sketches ``a``: a Lloyd
    round ends by assigning every row to its nearest center, so every
    row's label names a nearest served center (``label_miss`` counts the
    rows whose labelled center is farther than the nearest by more than
    ``TIE`` of the distances' scale, the fp32 rounding of a distance
    taken by the expansion), and the served centers are the means of the
    rows they label once Lloyd has converged (``center_err``); a cold
    round seeds k distinct rows and serves all k clusters
    (``cluster_shortfall``; a warm round may empty one, as Lloyd does
    from any start).  Returns ``(numbers, {})``."""
    k = int(centers.shape[0])
    means, _ = cluster_means(a, labels, k, "fp64")
    d2 = sqdist(a, centers)
    c = centers.to(d2.dtype)
    scale = (a * a).sum(dim=1) + (c * c).sum(dim=1).max()
    gap = d2.gather(1, labels[:, None])[:, 0] - d2.min(dim=1).values
    numbers = {"label_miss": int((gap > TIE * scale).sum()),
               "center_err": rel_err(centers, means)}
    if not warm:
        numbers["cluster_shortfall"] = cfg["clusters"] - k
    return numbers, {}


def objective(a: torch.Tensor, centers: torch.Tensor) -> float:
    """k-means' objective in fp64: each row's squared distance to its
    nearest center, summed."""
    return float(sqdist(a, centers).min(dim=1).values.sum())


def control(a: torch.Tensor, cfg: dict, lam, generator: torch.Generator,
            prec: str) -> tuple:
    """The control's clustering, and a draw of the ruler the seeding is
    held to: :func:`cluster` in ``prec``; returns ``(labels,
    centers)``."""
    opts = cfg["algo_options"]
    res = cluster(a, cfg["clusters"], iters=opts["iters"],
                  tol=cfg["lloyd_tol"], generator=generator, prec=prec)
    return res["labels"], res["centers"]
