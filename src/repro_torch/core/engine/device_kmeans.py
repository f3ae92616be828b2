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

Two options on top of the plain loop, as in the reference:

  * ``batch_m=b``: minibatch Lloyd.  Every iteration assigns and
    re-accumulates a without-replacement sample of b rows, drawn by the
    row sampler (``randperm_rows`` on the generator by default; the
    parity tests replay the reference's rows); the final labels and
    inertia are over all rows.  ``batch_m >= m`` is the full loop.
  * ``aggregator``: a robust center update.  The kernel's labels feed the
    registry aggregator (its sums go unused), and restarts are scored by
    the trimmed objective, the sum of the m - t smallest row distances
    with t = int(min(breakdown, 0.45) * m).

The loop runs on the rows of a ``shard`` (a ``sharding.clients.RowShard``;
one process's ``LocalShard`` where none is given, whose collectives are
the identity).  Under a mesh ``points`` are this rank's rows: every
iteration launches the kernel on them alone, all-reduces the (k, d) sums
and (k,) counts (one collective), and updates the replicated centers, so
the stop test reads replicated values and every rank leaves at the same
``n_iter``.  Minibatch rows are drawn globally on every rank from the
same generator and each rank takes the ones it owns; restarts compare
all-reduced objectives; the labels come back gathered, in global row
order.

Inertia is computed directly, sum_i ||x_i - c_label(i)||^2.  The
reference's accumulator formula (``device_kmeans.py:115-121``,
``sum ||x||^2 - 2 sum <sums, c> + sum counts ||c||^2``) loses digits to
cancellation and is not copied.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.clustering.kmeans import init_centers as seed_centers
from repro_torch.core.clustering.kmeans import randperm_rows
from repro_torch.kernels import ops as kops
from repro_torch.sharding.clients import shard_of


class DeviceKMeansResult(NamedTuple):
    labels: torch.Tensor          # (m,) int32 cluster assignment
    centers: torch.Tensor         # (k, d) float32 cluster centers
    inertia: torch.Tensor         # () the restart objective (see above)
    n_iter: int                   # Lloyd iterations actually run
    restart_spread: float = 0.0   # max - min final inertia over restarts


def _init_centers(generator, points, k: int, init: str, init_centers,
                  sampler, shard):
    if init == "warm":
        if init_centers is None:
            raise ValueError("init='warm' requires init_centers")
        centers = torch.as_tensor(init_centers, dtype=torch.float32,
                                  device=points.device)
        if tuple(centers.shape) != (k, points.shape[1]):
            raise ValueError(f"init_centers must be ({k}, {points.shape[1]}), "
                             f"got {tuple(centers.shape)}")
        return centers.clone()
    return seed_centers(generator, points, k, init, sampler, shard)


def direct_inertia(points, centers, labels, shard=None) -> torch.Tensor:
    """sum_i ||x_i - c_label(i)||^2, computed from the differences (over
    every rank's rows of a ``shard``)."""
    return shard_of(points, shard).all_reduce(
        torch.sum((points - centers[labels.long()]) ** 2))


def trimmed_inertia(points, centers, labels, t: int,
                    shard=None) -> torch.Tensor:
    """The trimmed k-means objective: the sum of the m - t smallest row
    distances (the t farthest rows pay nothing)."""
    d2 = shard_of(points, shard).gather(
        torch.sum((points - centers[labels.long()]) ** 2, dim=1))
    return torch.sum(torch.topk(d2, d2.shape[0] - t, largest=False,
                                sorted=False).values)


def _lloyd(generator, points, k: int, iters: int, init: str, tol: float,
           init_centers, batch_m: Optional[int], aggregator,
           sampler, shard) -> DeviceKMeansResult:
    m = shard.total
    centers = _init_centers(generator, points, k, init, init_centers,
                            sampler, shard)
    n_iter = 0
    for _ in range(iters):
        batch, rows = points, shard
        if batch_m is not None:
            sel, rows = shard.select(
                sampler(generator, m, batch_m).to(points.device))
            batch = points[sel]
        labels_b, sums, counts = kops.kmeans_assign(batch, centers)
        sums, counts = shard.all_reduce_pack(sums, counts)
        if aggregator is None:
            means = sums / torch.clamp_min(counts, 1.0)[:, None]
        else:
            onehot = torch.nn.functional.one_hot(labels_b.long(), k).to(
                torch.float32)
            means = aggregator(batch, labels_b, onehot, counts, shard=rows)
        new_centers = torch.where(counts[:, None] > 0, means, centers)
        moved = torch.max(torch.sum((new_centers - centers) ** 2, dim=1))
        centers = new_centers
        n_iter += 1
        if bool(moved < tol):
            break
    labels, _, _ = kops.kmeans_assign(points, centers)
    trim = min(float(getattr(aggregator, "breakdown", 0.0) or 0.0), 0.45)
    t = int(trim * m)
    inertia = (direct_inertia(points, centers, labels, shard) if t == 0
               else trimmed_inertia(points, centers, labels, t, shard))
    return DeviceKMeansResult(labels=labels, centers=centers,
                              inertia=inertia, n_iter=n_iter)


def _restart_generator(generator: torch.Generator, i: int) -> torch.Generator:
    """The i-th restart's generator, derived from the caller's seed
    without drawing from the caller's generator (so restart 0 is exactly
    the single-restart run)."""
    seed = (generator.initial_seed() + 0x9E3779B97F4A7C15 * i) % (1 << 63)
    return torch.Generator(device=generator.device).manual_seed(seed)


def device_kmeans(generator: torch.Generator, points: torch.Tensor, k: int,
                  iters: int = 50, init: str = "kmeans++", tol: float = 1e-8,
                  restarts: int = 1, batch_m: Optional[int] = None,
                  aggregator=None, init_centers=None,
                  sampler=None, shard=None) -> DeviceKMeansResult:
    """Lloyd's algorithm on the fused assign kernel.

    ``init``: ``kmeans++`` | ``spectral`` | ``random`` | ``warm`` (from
    ``init_centers``).  ``restarts=r`` runs r inits, the caller's
    generator first, and keeps the lowest objective (``restart_spread``
    reports max - min); spectral seeding and a warm start ignore the
    generator, so at full batch they run once.  ``batch_m`` samples that
    many rows an iteration (``>= m`` is the full loop); ``aggregator`` (a
    registry instance, ``None`` for the kernel's mean) replaces the
    center update; ``sampler(generator, m, n)`` draws the rows of the
    random init and of every minibatch.  ``shard``: ``points`` are this
    rank's rows of a row-sharded matrix (see the module docstring); the
    labels come back for every row, in global order."""
    points = points.to(torch.float32).contiguous()
    shard = shard_of(points, shard)
    m = shard.total
    sampler = randperm_rows if sampler is None else sampler
    if batch_m is not None and batch_m >= m:
        batch_m = None                      # the full loop
    if init in ("spectral", "warm") and batch_m is None:
        restarts = 1
    if restarts <= 1:
        return _global_labels(_lloyd(generator, points, k, iters, init, tol,
                                     init_centers, batch_m, aggregator,
                                     sampler, shard), shard)
    runs = [_lloyd(generator if i == 0 else _restart_generator(generator, i),
                   points, k, iters, init, tol, init_centers, batch_m,
                   aggregator, sampler, shard)
            for i in range(restarts)]
    inertias = torch.stack([r.inertia for r in runs]).cpu()
    best = int(torch.argmin(inertias))
    return _global_labels(runs[best]._replace(
        restart_spread=float(inertias.max() - inertias.min())), shard)


def _global_labels(res: DeviceKMeansResult, shard) -> DeviceKMeansResult:
    return res._replace(labels=shard.gather(res.labels))
