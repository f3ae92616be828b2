"""Device Lloyd loop (the port of ``repro/core/engine/device_kmeans.py``).

Every iteration is one launch of the fused ``kmeans_assign`` kernel:
labels plus per-cluster sums and counts, so the only state besides the
centers is the (k, d) accumulator.  The update rule is the reference's:
empty clusters keep their center, and the loop freezes at the first
iteration whose largest squared center move is below ``tol`` (that
iteration counts in ``n_iter``).  The reference runs all ``iters``
steps of its ``scan`` frozen; this loop stops there instead, at the
cost of one host sync per iteration, with the same centers, labels and
``n_iter``.

Inertia is computed directly, sum_i ||x_i - c_label(i)||^2.  The
reference's accumulator formula (``device_kmeans.py:115-121``,
``sum ||x||^2 - 2 sum <sums, c> + sum counts ||c||^2``) loses digits to
cancellation and is not copied.  ``batch_m`` (minibatch Lloyd), the
spectral init and robust center updates come later.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.clustering.kmeans import (
    kmeans_plus_plus_init,
    random_init,
)
from repro_torch.kernels import ops as kops


class DeviceKMeansResult(NamedTuple):
    labels: torch.Tensor          # (m,) int32 cluster assignment
    centers: torch.Tensor         # (k, d) float32 cluster centers
    inertia: torch.Tensor         # () sum of squared distances to the center
    n_iter: int                   # Lloyd iterations actually run
    restart_spread: float = 0.0   # max - min final inertia over restarts


def _init_centers(generator, points, k: int, init: str, init_centers):
    if init == "warm":
        if init_centers is None:
            raise ValueError("init='warm' requires init_centers")
        centers = torch.as_tensor(init_centers, dtype=torch.float32,
                                  device=points.device)
        if tuple(centers.shape) != (k, points.shape[1]):
            raise ValueError(f"init_centers must be ({k}, {points.shape[1]}), "
                             f"got {tuple(centers.shape)}")
        return centers.clone()
    if init == "kmeans++":
        return kmeans_plus_plus_init(generator, points, k)
    if init == "random":
        return random_init(generator, points, k)
    raise ValueError(f"unknown init {init!r}; the port has 'kmeans++', "
                     "'random' and 'warm' (spectral comes later)")


def direct_inertia(points, centers, labels) -> torch.Tensor:
    """sum_i ||x_i - c_label(i)||^2, computed from the differences."""
    return torch.sum((points - centers[labels.long()]) ** 2)


def _lloyd(generator, points, k: int, iters: int, init: str, tol: float,
           init_centers) -> DeviceKMeansResult:
    centers = _init_centers(generator, points, k, init, init_centers)
    n_iter = 0
    for _ in range(iters):
        _, sums, counts = kops.kmeans_assign(points, centers)
        means = sums / torch.clamp_min(counts, 1.0)[:, None]
        new_centers = torch.where(counts[:, None] > 0, means, centers)
        moved = torch.max(torch.sum((new_centers - centers) ** 2, dim=1))
        centers = new_centers
        n_iter += 1
        if bool(moved < tol):
            break
    labels, _, _ = kops.kmeans_assign(points, centers)
    return DeviceKMeansResult(labels=labels, centers=centers,
                              inertia=direct_inertia(points, centers, labels),
                              n_iter=n_iter)


def _restart_generator(generator: torch.Generator, i: int) -> torch.Generator:
    """The i-th restart's generator, derived from the caller's seed
    without drawing from the caller's generator (so restart 0 is exactly
    the single-restart run)."""
    seed = (generator.initial_seed() + 0x9E3779B97F4A7C15 * i) % (1 << 63)
    return torch.Generator(device=generator.device).manual_seed(seed)


def device_kmeans(generator: torch.Generator, points: torch.Tensor, k: int,
                  iters: int = 50, init: str = "kmeans++", tol: float = 1e-8,
                  restarts: int = 1,
                  init_centers=None) -> DeviceKMeansResult:
    """Lloyd's algorithm on the fused assign kernel.

    ``restarts=r`` runs r inits, the caller's generator first, and keeps
    the lowest inertia (``restart_spread`` reports max - min); a warm
    start (``init="warm"`` from ``init_centers``) ignores the generator,
    so it runs once."""
    points = points.to(torch.float32).contiguous()
    if init == "warm":
        restarts = 1
    if restarts <= 1:
        return _lloyd(generator, points, k, iters, init, tol, init_centers)
    runs = [_lloyd(generator if i == 0 else _restart_generator(generator, i),
                   points, k, iters, init, tol, init_centers)
            for i in range(restarts)]
    inertias = torch.stack([r.inertia for r in runs]).cpu()
    best = int(torch.argmin(inertias))
    return runs[best]._replace(
        restart_spread=float(inertias.max() - inertias.min()))


def _check_options(batch_m: Optional[int], m: int, aggregator) -> None:
    if batch_m is not None and batch_m < m:
        raise NotImplementedError("minibatch Lloyd (batch_m < m) is not "
                                  "ported yet")
    if aggregator is not None and getattr(aggregator, "name",
                                          aggregator) != "mean":
        raise NotImplementedError("robust Lloyd center updates are not "
                                  "ported yet; only the mean")
