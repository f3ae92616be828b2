"""Staleness policies for the mutable ``AggregationSession`` (the port's
copy of ``repro/core/engine/staleness.py``, which imports nothing of JAX
but belongs to the reference package).

A long-lived server ingests the same clients repeatedly and keeps rows
for clients that stopped uploading; freshness is a policy decision.
Ages are LOGICAL: the session advances a clock by one per ingested
wave, stamps every written row with the post-ingest clock, and asks the
policy about ``age = clock - stamp`` (the latest wave is age 0).  Two
orthogonal knobs:

  * ``evict(ages) -> bool mask``     — hard forgetting: masked rows are
    removed from the slot table, returned to the free list, and never
    reach another finalize.
  * ``weights(ages) -> None | (n,)`` — soft forgetting: per-row weights
    for the finalize's per-cluster parameter mean (``None`` keeps the
    unweighted path, which stays equal to the fused round).

Policies are small frozen dataclasses (hashable, like the aggregator
and edge-set registries): ``none`` keeps everything forever,
``max_age`` is the sliding window, ``exp_decay`` keeps every row but
halves its averaging weight every ``half_life`` waves.
``make_staleness_policy`` also parses the CLI spellings
(``"max_age=3"``, ``"exp_decay=2.0"``) used by ``launch/simulate.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class NoStaleness:
    """Keep every row forever, unweighted (the pre-mutation behaviour)."""
    name: str = "none"

    def evict(self, ages) -> np.ndarray:
        return np.zeros(np.shape(ages), bool)

    def weights(self, ages) -> Optional[np.ndarray]:
        return None


@dataclasses.dataclass(frozen=True)
class SlidingWindow:
    """Hard sliding window: evict rows whose age exceeds ``max_age``
    waves (a client survives by re-uploading before the window closes)."""
    max_age: int = 4
    name: str = "max_age"

    def __post_init__(self):
        if self.max_age < 1:
            raise ValueError(f"max_age must be >= 1, got {self.max_age}")

    def evict(self, ages) -> np.ndarray:
        return np.asarray(ages) > self.max_age

    def weights(self, ages) -> Optional[np.ndarray]:
        return None


@dataclasses.dataclass(frozen=True)
class ExpDecay:
    """Soft forgetting: never evict, but weight each row's contribution
    to the per-cluster parameter mean by ``0.5 ** (age / half_life)`` —
    stale uploads fade instead of falling off a cliff."""
    half_life: float = 4.0
    name: str = "exp_decay"

    def __post_init__(self):
        if self.half_life <= 0:
            raise ValueError(
                f"half_life must be > 0, got {self.half_life}")

    def evict(self, ages) -> np.ndarray:
        return np.zeros(np.shape(ages), bool)

    def weights(self, ages) -> Optional[np.ndarray]:
        return 0.5 ** (np.asarray(ages, np.float64) / self.half_life)


def make_staleness_policy(spec, **options):
    """Resolve a policy: an instance passes through; a name builds one
    (``"none"`` | ``"max_age"`` | ``"exp_decay"``) with keyword options
    (``max_age=``, ``half_life=``); the CLI spellings ``"max_age=3"``
    and ``"exp_decay=2.0"`` parse their single parameter inline."""
    if spec is None:
        return NoStaleness()
    if not isinstance(spec, str):
        return spec
    name, _, arg = spec.partition("=")
    if name == "none":
        return NoStaleness()
    if name in ("max_age", "sliding_window"):
        try:
            max_age = int(arg) if arg else options.get("max_age")
            return (SlidingWindow() if max_age is None
                    else SlidingWindow(max_age))
        except ValueError as err:
            raise ValueError(
                f"invalid staleness spec {spec!r}: max_age must be an "
                f"integer >= 1 ({err})") from None
    if name == "exp_decay":
        try:
            half_life = float(arg) if arg else options.get("half_life")
            return ExpDecay() if half_life is None else ExpDecay(half_life)
        except ValueError as err:
            raise ValueError(
                f"invalid staleness spec {spec!r}: half_life must be a "
                f"number > 0 ({err})") from None
    raise ValueError(f"unknown staleness policy {spec!r}; "
                     "known: none | max_age | exp_decay")
