"""Per-cluster aggregation, step 3 of Algorithm 1, as a registry (the
port's subset of ``repro/core/engine/aggregators.py``): the paper's
``mean``.  The robust aggregators (trimmed mean, median, geometric
median) come later.

Contract: ``agg(flat, labels, onehot, counts) -> (K, n) float32`` with
``flat`` the (C, n) float32 stack of one flattened leaf, ``onehot`` the
(C, K) indicator and ``counts`` the raw (K,) cluster sizes; empty
clusters aggregate to 0.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.utils import tree_map


@dataclasses.dataclass(frozen=True)
class MeanAggregator:
    """The paper's step 3: masked per-cluster mean."""
    name: str = "mean"

    def __call__(self, flat, labels, onehot, counts):
        return (onehot.T @ flat) / torch.clamp_min(counts, 1.0)[:, None]


def _reduce_leaf(leaf, labels, onehot, counts, aggregator):
    flat = leaf.reshape(leaf.shape[0], -1).to(torch.float32)
    return aggregator(flat, labels, onehot, counts)


def cluster_aggregate_tree(params, labels, onehot, counts, aggregator):
    """Steps 3-4: per-cluster reduction of every leaf, gathered back per
    client (row i gets its cluster's aggregate; the gather equals the
    reference's ``onehot @ reduced`` exactly)."""
    agg = get_aggregator(aggregator)
    idx = labels.long()

    def back(leaf):
        reduced = _reduce_leaf(leaf, labels, onehot, counts, agg)
        return reduced[idx].reshape(leaf.shape).to(leaf.dtype)

    return tree_map(back, params)


_AGGREGATORS: dict = {}


def register_aggregator(agg, *, name: Optional[str] = None,
                        overwrite: bool = False):
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


register_aggregator(MeanAggregator())
