"""The launch plan of the streaming kernels (``csrc/row_stream.cuh``):
rows a tile and ring depth for a given shared-memory layout.

Pure functions of the shapes, so the CPU tests can hold the wrappers'
choices at their edges; the C entry points recompute the same layout and
refuse a plan that does not fit.
"""
from __future__ import annotations

import functools

import torch

MAX_ROWS = 256        # rows a tile: one per consumer thread
MAX_STAGES = 4        # tiles in flight
# shared memory one block may opt into on an H100 (227 KB); the C side
# launches with the plan's bytes and the card refuses more
SMEM_PER_BLOCK = 232_448
BARRIER_BYTES = 16 * MAX_STAGES + 16       # full/empty mbarriers and a flag
BOX_COLS = 32         # columns of one TMA box: a 128-byte line a row
ALIGN = 1024          # the ring's alignment (a 128-byte swizzle atom)


def up16(n: int) -> int:
    return (n + 15) & ~15


def padded_stride(d: int) -> int:
    """A plain staged row's stride in floats: d rounded up to whole 16-byte
    chunks, an odd number of them (conflict-free float4 reads)."""
    chunks = (d + 3) // 4
    return 4 * (chunks | 1)


def stage_bytes(d: int, rows: int) -> int:
    """One ring stage: ceil(d / 32) swizzled boxes of ``rows`` lines."""
    return -(-d // BOX_COLS) * rows * 128


def ring_plan(layout_bytes) -> tuple[int, int] | None:
    """(rows a tile, stages) for ``layout_bytes(rows, stages)``: full
    tiles of MAX_ROWS in the deepest ring that fits, else the most rows (a
    multiple of 8, the swizzle atom) that fit in two stages, then in one;
    None if not even 8 rows fit."""
    for stages in range(MAX_STAGES, 1, -1):
        if layout_bytes(MAX_ROWS, stages) <= SMEM_PER_BLOCK:
            return MAX_ROWS, stages
    for stages in (2, 1):
        for rows in range(MAX_ROWS - 8, 0, -8):
            if layout_bytes(rows, stages) <= SMEM_PER_BLOCK:
                return rows, stages
    return None


@functools.lru_cache(maxsize=16)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of a CUDA device: the persistent grids'
    most blocks."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count
