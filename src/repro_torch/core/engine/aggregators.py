"""Per-cluster aggregation, step 3 of Algorithm 1, as a registry (the
port of ``repro/core/engine/aggregators.py``):

  * ``mean``             the paper's step 3 (breakdown point 0).
  * ``trimmed_mean``     coordinate-wise beta-trimmed mean: per cluster
                         and coordinate, drop the t smallest and the t
                         largest values and average the rest.
  * ``median``           coordinate-wise median per cluster.
  * ``geometric_median`` 16 fixed Weiszfeld steps in the full row space
                         (row-wise robust, breakdown 1/2).

The order statistics come from one segment sort of every column keyed on
(cluster label, value).  The reference sorts with
``jax.lax.sort(..., num_keys=2)``; here two stable sorts do it, first by
value, then by label, which gives the same (stable) order.

Contract: ``agg(flat, labels, onehot, counts) -> (K, n) float32`` with
``flat`` the (C, n) float32 stack of one flattened leaf, ``labels`` the
(C,) cluster ids in [0, K), ``onehot`` the (C, K) indicator and
``counts`` the raw (K,) cluster sizes; empty clusters aggregate to 0.
``breakdown`` is the largest in-cluster corruption fraction the
aggregator tolerates; the device Lloyd loop reads it to score restarts
by the trimmed objective.

Every aggregator also takes ``shard`` (a ``sharding.clients.RowShard``,
the one-process ``LocalShard`` when omitted): the rows lie on its ranks,
``flat``, ``labels`` and ``onehot`` are this rank's and ``counts`` the
all-reduced sizes, and the (K, n) result is the same on every rank.  The
mean and the geometric median all-reduce their per-cluster sums (each
Weiszfeld step is a sum over rows); the coordinate-wise order statistics
(trimmed mean, median) need whole columns, so they gather the rows in
column blocks of at most ``GATHER_BYTES``.  On one process every
collective is the identity.
"""
from __future__ import annotations

import math
import dataclasses
from typing import Any, Optional, Protocol, runtime_checkable

import torch

from repro_torch.sharding.clients import shard_of
from repro_torch.utils import tree_map

# a gathered column block: at most this many bytes, rows x columns x 4
# (64 MiB: 16 columns of C = 1 048 576 clients)
GATHER_BYTES = 1 << 26


@runtime_checkable
class Aggregator(Protocol):
    """A per-cluster reduction (the module's contract above): ``name``,
    the ``breakdown`` point, and ``__call__(flat, labels, onehot, counts,
    shard=None) -> (K, n) float32``.  The registry also takes any object
    with these members."""
    name: str
    breakdown: float = 0.0

    def __call__(self, flat: torch.Tensor, labels: torch.Tensor,
                 onehot: torch.Tensor, counts: torch.Tensor,
                 shard=None) -> torch.Tensor: ...


# ------------------------------------------------- segment order statistics

def _segment_sort(flat, labels):
    """Column-wise stable sort of ``flat`` keyed on (label, value).

    Returns ``(vals, sorted_labels, perm)``: ``vals[i, j]`` the i-th value
    of column j in (label, value) order, ``sorted_labels`` the (C,)
    ascending label of each sorted slot (the same in every column),
    ``perm[i, j]`` the original row behind sorted slot i of column j."""
    vals, by_value = torch.sort(flat, dim=0, stable=True)
    lab = labels.long()[by_value]                          # (C, n)
    sorted_lab, by_label = torch.sort(lab, dim=0, stable=True)
    perm = torch.gather(by_value, 0, by_label)
    return torch.gather(vals, 0, by_label), sorted_lab[:, 0], perm


def _cluster_ranks(flat, labels):
    """(C, n) rank of every coordinate within its cluster's column, in the
    original row layout, so masks built from it compose with the same
    ``onehot.T @ masked`` contraction as the mean."""
    c, n = flat.shape
    _, sl, perm = _segment_sort(flat, labels)
    pos = torch.arange(c, device=flat.device)
    is_start = torch.ones(c, dtype=torch.bool, device=flat.device)
    is_start[1:] = sl[1:] != sl[:-1]
    seg_start = torch.cummax(torch.where(is_start, pos, 0), dim=0).values
    rank_sorted = (pos - seg_start)[:, None].expand(c, n)
    return torch.zeros((c, n), dtype=torch.long,
                       device=flat.device).scatter_(0, perm, rank_sorted)


# ------------------------------------------------------------- aggregators

@dataclasses.dataclass(frozen=True)
class MeanAggregator:
    """The paper's step 3: masked per-cluster mean (breakdown point 0)."""
    name: str = "mean"
    breakdown = 0.0

    def __call__(self, flat, labels, onehot, counts, shard=None):
        sums = shard_of(flat, shard).all_reduce(onehot.T @ flat)
        return sums.div_(torch.clamp_min(counts, 1.0)[:, None])


@dataclasses.dataclass(frozen=True)
class TrimmedMeanAggregator:
    """Coordinate-wise beta-trimmed mean (breakdown point beta).

    Per cluster of size cnt the trim budget is
    ``t = min(floor(beta * cnt), (cnt - 1) // 2)``, so at least one value
    survives; at t = 0 the masked matrix is ``flat`` itself and the result
    equals ``mean`` exactly."""
    beta: float = 0.1
    name: str = "trimmed_mean"

    @property
    def breakdown(self) -> float:
        return self.beta

    def __post_init__(self):
        if not 0.0 <= self.beta < 0.5:
            raise ValueError(f"trim fraction beta must be in [0, 0.5), "
                             f"got {self.beta}")

    def __call__(self, flat, labels, onehot, counts, shard=None):
        return _by_column_blocks(self._columns, flat, labels, onehot, counts,
                                 shard)

    def _columns(self, flat, labels, onehot, counts):
        cnt = counts.to(torch.long)
        t = torch.minimum(torch.floor(self.beta * counts).to(torch.long),
                          torch.clamp_min(torch.div(cnt - 1, 2,
                                                    rounding_mode="floor"),
                                          0))
        rank = _cluster_ranks(flat, labels)                     # (C, n)
        t_row = t[labels.long()][:, None]
        cnt_row = cnt[labels.long()][:, None]
        keep = (rank >= t_row) & (rank < cnt_row - t_row)
        masked = torch.where(keep, flat, torch.zeros((), dtype=flat.dtype,
                                                     device=flat.device))
        denom = torch.clamp_min(counts - 2.0 * t.to(counts.dtype), 1.0)
        return (onehot.T @ masked) / denom[:, None]


@dataclasses.dataclass(frozen=True)
class GeometricMedianAggregator:
    """Per-cluster geometric median by ``iters`` fixed Weiszfeld steps
    (breakdown point 1/2): ``y <- sum_i w_i x_i / sum_i w_i`` with
    ``w_i = [label_i == k] / max(||x_i - y||, eps)``, the distances by the
    reference's expansion ||x||^2 - 2 x.y + ||y||^2, from the masked
    per-cluster mean; empty clusters give 0."""
    iters: int = 16
    eps: float = 1e-8
    name: str = "geometric_median"
    breakdown = 0.5

    def __post_init__(self):
        if self.iters < 1:
            raise ValueError(f"iters must be >= 1, got {self.iters}")
        if self.eps <= 0:
            raise ValueError(f"eps must be > 0, got {self.eps}")

    def __call__(self, flat, labels, onehot, counts, shard=None):
        shard = shard_of(flat, shard)
        y = (shard.all_reduce(onehot.T @ flat)
             / torch.clamp_min(counts, 1.0)[:, None])
        sq = torch.sum(flat * flat, dim=1)                      # (C,)
        for _ in range(self.iters):
            d2 = (sq[:, None] - 2.0 * (flat @ y.T)
                  + torch.sum(y * y, dim=1)[None, :])
            d = torch.sqrt(torch.clamp_min(d2, 0.0))
            w = onehot / torch.clamp_min(d, self.eps)           # (C, K)
            num, den = shard.all_reduce_pack(w.T @ flat,
                                             torch.sum(w, dim=0))
            y = num / torch.clamp_min(den, self.eps)[:, None]
        return torch.where(counts[:, None] > 0, y, torch.zeros_like(y))


@dataclasses.dataclass(frozen=True)
class MedianAggregator:
    """Coordinate-wise per-cluster median (breakdown point 1/2): the mean
    of the two middle order statistics of every (cluster, column)
    segment, so size-1 and size-2 clusters give a and (a + b) / 2."""
    name: str = "median"
    breakdown = 0.5

    def __call__(self, flat, labels, onehot, counts, shard=None):
        return _by_column_blocks(self._columns, flat, labels, onehot, counts,
                                 shard)

    def _columns(self, flat, labels, onehot, counts):
        c = flat.shape[0]
        cnt = counts.to(torch.long)
        vals, _, _ = _segment_sort(flat, labels)
        starts = torch.cumsum(cnt, 0) - cnt                     # (K,)
        lo = torch.clamp(starts + torch.div(cnt - 1, 2, rounding_mode="floor"),
                         0, c - 1)
        hi = torch.clamp(starts + torch.div(cnt, 2, rounding_mode="floor"),
                         0, c - 1)
        med = 0.5 * (vals[lo] + vals[hi])                       # (K, n)
        return torch.where(counts[:, None] > 0, med, torch.zeros_like(med))



def _onehot(labels, k: int):
    """(C, k) float32 indicator; a label outside [0, k) gets a zero row, as
    ``jax.nn.one_hot`` gives it."""
    return (labels.long()[:, None]
            == torch.arange(k, device=labels.device)).to(torch.float32)


def _by_column_blocks(columns, flat, labels, onehot, counts, shard):
    """A coordinate-wise aggregator over rows spread as ``shard``: the
    labels, the one-hot and each block of columns gathered (every rank
    then holds the block's whole columns, at most ``GATHER_BYTES``) and
    reduced by ``columns(flat, labels, onehot, counts)``."""
    shard = shard_of(flat, shard)
    labels, onehot = shard.gather(labels), shard.gather(onehot)
    cols = max(1, GATHER_BYTES // (4 * max(labels.shape[0], 1)))
    blocks = [columns(shard.gather(flat[:, j:j + cols].contiguous()),
                      labels, onehot, counts)
              for j in range(0, flat.shape[1], cols)]
    return torch.cat(blocks, dim=1)


# --------------------------------------------------------- tree wrappers

def _leaf_reps(agg, leaf, labels, onehot, counts, shard=None):
    """One leaf's (K, ...) float32 representatives."""
    # (a rank may hold no row of the leaf: the width is explicit)
    flat = leaf.reshape(leaf.shape[0], math.prod(leaf.shape[1:])).to(
        torch.float32)
    return agg(flat, labels, onehot, counts, shard=shard).reshape(
        (onehot.shape[1],) + tuple(leaf.shape[1:]))


def cluster_reduce_tree(params, labels, onehot, counts, aggregator,
                        shard=None, then=None):
    """Step 3: every leaf's (K, ...) per-cluster representatives, in the
    leaf's dtype, one leaf at a time (under a mesh no (K, n) buffer of the
    whole model is held at once), from this rank's rows (``labels``,
    ``onehot`` and ``params``; every row where ``shard`` is None) and the
    (K,) ``counts`` of all of them.  ``then`` maps each leaf's
    representatives as soon as they exist (so they need not all be held
    either).  The one body of every per-cluster mean of the port."""
    agg = get_aggregator(aggregator)

    def rep(leaf):
        out = _leaf_reps(agg, leaf, labels, onehot, counts, shard).to(
            leaf.dtype)
        return out if then is None else then(out)

    return tree_map(rep, params)


def cluster_reps(labels, kk: int, params, aggregator, shard=None,
                 then=None):
    """``cluster_reduce_tree`` of K = ``kk`` clusters from this rank's
    ``labels`` alone: the one-hot made here, the counts all-reduced."""
    onehot = _onehot(labels, kk)
    counts = shard_of(labels, shard).all_reduce(torch.sum(onehot, dim=0))
    return cluster_reduce_tree(params, labels, onehot, counts, aggregator,
                               shard, then)


def cluster_aggregate_tree(params, labels, onehot, counts, aggregator):
    """Steps 3-4: per-cluster reduction of every leaf, gathered back per
    client as the reference computes it, ``onehot @ reduced`` in float32
    and then cast: a row with an all-zero one-hot gets zeros, whatever its
    label, a soft row the product, and a one-hot row its cluster's
    representative exactly (1 * y plus exact zeros; TF32 is off)."""
    agg = get_aggregator(aggregator)
    weights = onehot.to(torch.float32)

    def back(leaf):
        reps = _leaf_reps(agg, leaf, labels, onehot, counts)
        return (weights @ reps.reshape(reps.shape[0], -1)).reshape(
            leaf.shape).to(leaf.dtype)

    return tree_map(back, params)


# ------------------------------------------------------------- registry

_AGGREGATORS: dict = {}


def register_aggregator(agg: Aggregator, *, name: Optional[str] = None,
                        overwrite: bool = False) -> Aggregator:
    key = name if name is not None else agg.name
    if not key:
        raise ValueError("aggregator needs a non-empty name")
    if key in _AGGREGATORS and not overwrite:
        raise ValueError(f"aggregator {key!r} already registered "
                         "(pass overwrite=True to replace)")
    _AGGREGATORS[key] = agg
    return agg


def unregister_aggregator(name: str) -> None:
    _AGGREGATORS.pop(name, None)


def get_aggregator(name):
    """Resolve a name (or pass through an instance)."""
    if not isinstance(name, str):
        return name
    try:
        return _AGGREGATORS[name]
    except KeyError:
        raise KeyError(f"unknown aggregator {name!r}; registered: "
                       f"{sorted(_AGGREGATORS)}") from None


def list_aggregators() -> tuple:
    return tuple(sorted(_AGGREGATORS))


def make_aggregator(name, **options: Any):
    """Resolve ``name`` and set its dataclass fields from ``options``
    (unknown keys and ``None`` values are skipped, so drivers pass one
    flat superset): ``make_aggregator("trimmed_mean", beta=0.2)``."""
    agg = get_aggregator(name)
    if options and dataclasses.is_dataclass(agg):
        fields = {f.name for f in dataclasses.fields(agg) if f.init}
        kept = {k: v for k, v in options.items()
                if k in fields and k != "name" and v is not None}
        if kept:
            agg = dataclasses.replace(agg, **kept)
    return agg


for _agg in (MeanAggregator(), TrimmedMeanAggregator(), MedianAggregator(),
             GeometricMedianAggregator()):
    register_aggregator(_agg)
del _agg
