"""Deterministic segment sums.

The reference adds rows into segments with ``.at[ids].add`` (the AMA's
``u_of``, the root-indexed cluster sums).  ``index_add_`` on CUDA adds
with float atomics, so such a sum would change in its last bits from run
to run.  Here the slots are sorted by segment once (a stable sort, so
each segment keeps its slots in their original order) and every
segment's run is reduced in order by ``torch.segment_reduce``: the same
inputs give the same bits on every run.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class SegmentPlan(NamedTuple):
    """Where each segment's slots lie once they are grouped."""
    order: Optional[torch.Tensor]    # (n,) int32 slot order; None: grouped
    lengths: torch.Tensor            # (segments,) int64 slots per segment
    starts: torch.Tensor             # (segments + 1,) int64 run offsets


def segment_plan(ids: torch.Tensor, segments: int) -> SegmentPlan:
    """Plan the sums of slots ``ids`` (n,) into ``segments`` segments.
    Ids that are already sorted (the complete graph's heads) skip the
    gather.  Segment s's slots are ``order[starts[s]:starts[s + 1]]``
    (the AMA's gather-back kernel reads the runs so)."""
    ids = ids.long()
    lengths = torch.bincount(ids, minlength=segments)
    starts = torch.nn.functional.pad(torch.cumsum(lengths, 0), (1, 0))
    if ids.numel() < 2 or bool((ids[1:] >= ids[:-1]).all()):
        return SegmentPlan(order=None, lengths=lengths, starts=starts)
    order = torch.argsort(ids, stable=True).to(torch.int32)
    return SegmentPlan(order=order, lengths=lengths, starts=starts)


def segment_sum(values: torch.Tensor, plan: SegmentPlan,
                axis: int = 0) -> torch.Tensor:
    """Sum ``values`` along ``axis`` (its slots) into the plan's segments;
    empty segments are 0."""
    if plan.order is not None:
        values = torch.index_select(values, axis, plan.order)
    lengths = plan.lengths.expand(*values.shape[:axis], -1).contiguous()
    return torch.segment_reduce(values, "sum", lengths=lengths, axis=axis,
                                unsafe=True)
