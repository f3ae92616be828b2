"""Pluggable fusion graphs for the device convex-clustering family (the
port of ``repro/core/engine/edges.py``).

The AMA solver (``engine/device_convex.py``) runs over an edge list:

  * ``Edges`` — what every builder returns: upper-triangular
    ``(i_idx, j_idx)`` endpoints, per-edge ``weights`` (0 marks an inert
    slot, e.g. the second copy of a mutual kNN pair: a zero radius
    projects its dual to zero) and ``inv_eta``, the reciprocal AMA step.
  * ``CompleteEdges`` (``"complete"``) — the paper's graph, all
    m(m-1)/2 pairs at weight 1, ``inv_eta = m`` as a Python float.
  * ``KnnEdges`` (``"knn"``) — the mutual-kNN graph: row tiles of the
    distance matrix stream through ``kernels.ops.pairwise_sqdist``,
    ``torch.topk`` shortlists each row's 2k nearest and ``_nearest``
    keeps the k nearest by their exact distance (so the card and the CPU
    pick the same neighbours); E = m*k slots, weights degree-normalized
    to (m-1)/avg_degree, ``inv_eta = 2 * max_degree``.
  * ``ApproxKnnEdges`` (``"knn-approx"``) — projection LSH: each of
    ``n_tables`` directions sorts the points, the order is cut into
    buckets, and the exact top-k runs over each bucket's window of three
    buckets (one batched ``pairwise_sqdist`` launch per table); tables
    merge by index dedup.  At m <= 3*bucket it is the exact builder.

The LSH directions come from a ``torch.Generator`` seeded with ``seed``;
``directions=`` (n_tables, d) takes explicit ones (how the parity tests
carry the reference's ``jax.random`` draws across).  The 1-D projections
are summed column by column in a fixed order, so the card and the CPU
sort the points identically.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Protocol, runtime_checkable

import torch

from repro_torch.kernels import ops as kops


class Edges(NamedTuple):
    """A fusion graph on the points' device."""
    i_idx: torch.Tensor           # (E,) int64, i < j on active slots
    j_idx: torch.Tensor           # (E,) int64
    weights: torch.Tensor         # (E,) float32, 0 = inert slot
    inv_eta: Any                  # python float or () f32; step = 1/inv_eta
    min_dist: Optional[torch.Tensor] = None   # () min neighbour distance,
    #                                           when the builder has it

    @property
    def n_edges(self) -> int:
        return int(self.i_idx.shape[0])


@runtime_checkable
class EdgeSet(Protocol):
    """A registered fusion-graph builder: (m, d) points in, ``Edges`` on
    their device out.  The registry takes any object with these
    members."""
    name: str

    def __call__(self, points, **options: Any) -> Edges: ...


# Above this many points the complete graph's index arrays alone (two
# int64 vectors of m(m-1)/2 entries) pass ~4 GB and grow quadratically.
COMPLETE_EDGES_MAX_M = 16384


@dataclasses.dataclass(frozen=True)
class CompleteEdges:
    """All m(m-1)/2 pairs at uniform weight 1: the paper's fusion graph.
    ``inv_eta = m`` (rho(A A^T) = m), the host solver's step.  Refused
    above ``max_m`` points."""
    name: str = "complete"

    def __call__(self, points, *, max_m: int = COMPLETE_EDGES_MAX_M,
                 **_: Any) -> Edges:
        m = points.shape[0]
        if m > max_m:
            raise ValueError(
                f"edges='complete' on m={m} points would build "
                f"{m * (m - 1) // 2:,} edges (~{m * (m - 1) * 8 / 1e9:.0f} "
                "GB of index arrays alone); use the sparse edges='knn' or "
                f"edges='knn-approx' fusion graphs above m={max_m}, or pass "
                "max_m= to raise the guard deliberately")
        iu = torch.triu_indices(m, m, 1, device=points.device)
        return Edges(i_idx=iu[0], j_idx=iu[1],
                     # one stored weight broadcast to every edge: the AMA
                     # then broadcasts lambda instead of copying it out
                     weights=torch.ones((), dtype=torch.float32,
                                        device=points.device).expand(
                                            iu.shape[1]),
                     inv_eta=float(max(m, 1)))


def _nearest(queries, points, cand, d2, k: int):
    """Of each query's candidates ``cand`` (n, c) with fp32 squared
    distances ``d2`` (n, c) (inf: not a candidate), keep the k nearest.

    The order comes from the exact (float64) distances of the candidates,
    lowest index first on exact ties; the fp32 values come back with
    them.  fp32 expansions from the kernel and from a matmul differ in
    their last bits, so ranking by them would let near-ties pick
    different neighbours on the card and on the CPU; the exact order is
    the same on both (and is the fp32 order wherever that has no
    near-tie).  Returns (idx (n, k) int64, d2 (n, k) fp32)."""
    by_index = torch.argsort(cand, dim=1, stable=True)
    cand = torch.gather(cand, 1, by_index)
    d2 = torch.gather(d2, 1, by_index)
    rows = points[torch.clamp(cand, max=points.shape[0] - 1)].double()
    diff = queries[:, None, :].double() - rows
    exact = torch.where(torch.isinf(d2), float("inf"),
                        torch.sum(diff * diff, dim=-1))
    sel = torch.argsort(exact, dim=1, stable=True)[:, :k]
    return torch.gather(cand, 1, sel), torch.gather(d2, 1, sel)


def _shortlist(d2, k: int):
    """Each row's min(2k, columns) smallest fp32 entries (the candidates
    ``_nearest`` ranks exactly)."""
    return torch.topk(d2, min(2 * k, d2.shape[-1]), dim=-1, largest=False,
                      sorted=False)


def _tiled_topk(points, k: int, tile: int):
    """Each row's k nearest other rows, one (tile, m) block of the
    distance matrix at a time.  Returns (idx (m,k) int64, dist (m,k))."""
    m = points.shape[0]
    tile = max(8, min(tile, m))
    idx, d2 = [], []
    for start in range(0, m, tile):
        blk = points[start:start + tile]
        dist = kops.pairwise_sqdist(blk, points)            # (t, m)
        rows = torch.arange(blk.shape[0], device=points.device)
        dist[rows, start + rows] = float("inf")
        val, sel = _shortlist(dist, k)
        sel, val = _nearest(blk, points, sel, val, k)
        idx.append(sel)
        d2.append(val)
    return torch.cat(idx), torch.sqrt(torch.clamp_min(torch.cat(d2), 0.0))


def _edges_from_neighbors(idx, dist) -> Edges:
    """The mutual-kNN ``Edges`` from per-row neighbour lists: one slot per
    (row, neighbour), canonicalized to (min, max); the copy of a mutual
    pair owned by the larger endpoint is inert.  Active weights are
    (m-1)/avg_degree, so the pull lambda * sum_j w_ij on a point matches
    the complete graph's."""
    m, k = idx.shape
    dev = idx.device
    rows = torch.arange(m, device=dev).repeat_interleave(k)
    nbrs = idx.reshape(-1)
    back = idx[idx]                                          # (m, k, k)
    mutual = torch.any(back == torch.arange(m, device=dev)[:, None, None],
                       dim=-1)
    keep = (rows < nbrs) | ~mutual.reshape(-1)
    i_idx = torch.minimum(rows, nbrs)
    j_idx = torch.maximum(rows, nbrs)
    n_active = torch.clamp_min(torch.sum(keep.to(torch.float32)), 1.0)
    # true fp32 divisions (a Python divisor is a reciprocal multiply on CUDA)
    avg_deg = 2.0 * n_active / torch.tensor(m, dtype=torch.float32,
                                            device=dev)
    w0 = torch.tensor(m - 1, dtype=torch.float32, device=dev) / avg_deg
    weights = torch.where(keep, w0, torch.zeros((), device=dev))
    # integer degree counts are exact in any order
    deg = (torch.bincount(i_idx[keep], minlength=m)
           + torch.bincount(j_idx[keep], minlength=m))
    inv_eta = torch.clamp_min(2.0 * torch.max(deg).to(torch.float32), 1.0)
    return Edges(i_idx=i_idx, j_idx=j_idx, weights=weights, inv_eta=inv_eta,
                 min_dist=torch.min(dist))


@dataclasses.dataclass(frozen=True)
class KnnEdges:
    """Exact mutual-kNN fusion graph (``_tiled_topk``: O(tile*m) memory,
    O(m^2 d) distance work)."""
    name: str = "knn"

    def __call__(self, points, *, knn_k: int = 8, tile: int = 1024,
                 **_: Any) -> Edges:
        m = points.shape[0]
        k = int(min(max(knn_k, 1), max(m - 1, 1)))
        if m < 2:
            return CompleteEdges()(points)
        idx, dist = _tiled_topk(points, k, tile)
        return _edges_from_neighbors(idx, dist)


def lsh_directions(n_tables: int, d: int, *, seed: int = 0,
                   device=None) -> torch.Tensor:
    """(n_tables, d) N(0, 1) projection directions from ``seed``, drawn
    on the CPU so every device gets the same tables."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((n_tables, d), generator=gen).to(device)


def _project(points, direction):
    """points @ direction, summed column by column in one fixed order (the
    same bits on every device, so every device sorts alike)."""
    acc = points[:, 0] * direction[0]
    for c in range(1, points.shape[1]):
        acc = acc + points[:, c] * direction[c]
    return acc


def _bucketed_topk(points, k: int, *, bucket: int, directions):
    """Approximate per-row k nearest neighbours by projection LSH; each
    table's windows of 3*bucket candidates go through one batched
    ``pairwise_sqdist``.  Returns (idx (m,k) int64, d2 (m,k))."""
    m, d = points.shape
    dev = points.device
    nb = (m + bucket - 1) // bucket
    mp = nb * bucket
    pad_rows = mp - m
    idx_all, d2_all = [], []
    for vt in directions:
        order = torch.argsort(_project(points, vt), stable=True)
        # pads: sentinel index m (masked below) at far-away points, so a
        # pad never wins a top-k slot
        order_p = torch.cat([order, torch.full((pad_rows,), m,
                                               dtype=torch.long, device=dev)])
        pts_p = torch.cat([points[order],
                           torch.full((pad_rows, d), 1e30,
                                      dtype=torch.float32, device=dev)])
        blocks = pts_p.reshape(nb, bucket, d)
        idx_blocks = order_p.reshape(nb, bucket)
        cands = torch.cat([torch.roll(blocks, 1, 0), blocks,
                           torch.roll(blocks, -1, 0)], dim=1).contiguous()
        cand_idx = torch.cat([torch.roll(idx_blocks, 1, 0), idx_blocks,
                              torch.roll(idx_blocks, -1, 0)], dim=1)
        d2 = kops.pairwise_sqdist(blocks, cands)             # (nb, B, 3B)
        invalid = ((cand_idx[:, None, :] == idx_blocks[:, :, None])
                   | (cand_idx[:, None, :] >= m))            # self + pads
        d2 = torch.where(invalid, float("inf"), d2)
        val, sel = _shortlist(d2, k)                         # (nb, B, 2k)
        nbr = torch.gather(cand_idx[:, None, :].expand(nb, bucket, 3 * bucket),
                           2, sel)
        # rank exactly, then unsort back to the original row order (pad
        # rows cut off first)
        nbr, val = _nearest(pts_p[:m], points, nbr.reshape(mp, -1)[:m],
                            val.reshape(mp, -1)[:m], k)
        idx_t = torch.empty((m, k), dtype=torch.long, device=dev)
        idx_t[order] = nbr
        d2_t = torch.empty((m, k), dtype=torch.float32, device=dev)
        d2_t[order] = val
        idx_all.append(idx_t)
        d2_all.append(d2_t)
    idx_all = torch.cat(idx_all, dim=1)                      # (m, T*k)
    d2_all = torch.cat(d2_all, dim=1)
    # cross-table dedup: sort each row's candidates by index, inf out the
    # repeats, keep the k nearest
    ord_ = torch.argsort(idx_all, dim=1, stable=True)
    idx_s = torch.gather(idx_all, 1, ord_)
    d2_s = torch.gather(d2_all, 1, ord_)
    dup = torch.cat([torch.zeros((m, 1), dtype=torch.bool, device=dev),
                     idx_s[:, 1:] == idx_s[:, :-1]], dim=1)
    d2_s = torch.where(dup, float("inf"), d2_s)
    return _nearest(points, points, idx_s, d2_s, k)


@dataclasses.dataclass(frozen=True)
class ApproxKnnEdges:
    """Approximate mutual-kNN fusion graph: the LSH candidate stage
    (``_bucketed_topk``) in place of the exact builder's m^2 distances,
    with the same edge assembly.  ``directions`` (n_tables, d) overrides
    the ``seed``-drawn ones.  At m <= 3*bucket the exact builder runs."""
    name: str = "knn-approx"

    def __call__(self, points, *, knn_k: int = 8, n_tables: int = 4,
                 bucket: Optional[int] = None, seed: int = 0,
                 tile: int = 1024, directions=None, **_: Any) -> Edges:
        m = points.shape[0]
        k = int(min(max(knn_k, 1), max(m - 1, 1)))
        if m < 2:
            return CompleteEdges()(points)
        if bucket is None:
            bucket = max(8 * k, 64)
        bucket = max(int(bucket), k + 1)
        if m <= 3 * bucket:
            idx, dist = _tiled_topk(points, k, tile)
            return _edges_from_neighbors(idx, dist)
        if directions is None:
            directions = lsh_directions(int(n_tables), points.shape[1],
                                        seed=int(seed), device=points.device)
        directions = torch.as_tensor(directions).to(points.device,
                                                    torch.float32)
        idx, d2 = _bucketed_topk(points, k, bucket=bucket,
                                 directions=directions)
        return _edges_from_neighbors(idx, torch.sqrt(torch.clamp_min(d2,
                                                                     0.0)))


# --------------------------------------------------------------- registry

_EDGE_SETS: dict = {}


def register_edge_set(builder: EdgeSet, *, name: Optional[str] = None,
                      overwrite: bool = False) -> EdgeSet:
    """Add a fusion-graph builder.  Returns it."""
    key = name if name is not None else builder.name
    if not key:
        raise ValueError("edge set needs a non-empty name")
    if key in _EDGE_SETS and not overwrite:
        raise ValueError(f"edge set {key!r} already registered "
                         "(pass overwrite=True to replace)")
    _EDGE_SETS[key] = builder
    return builder


def unregister_edge_set(name: str) -> None:
    _EDGE_SETS.pop(name, None)


def get_edge_set(name):
    """Resolve a name (or pass through a builder)."""
    if not isinstance(name, str):
        return name
    try:
        return _EDGE_SETS[name]
    except KeyError:
        raise KeyError(f"unknown edge set {name!r}; "
                       f"registered: {sorted(_EDGE_SETS)}") from None


def list_edge_sets() -> tuple:
    return tuple(sorted(_EDGE_SETS))


for _b in (CompleteEdges(), KnnEdges(), ApproxKnnEdges()):
    register_edge_set(_b)
del _b
