"""Fused Lloyd step (assign + per-cluster sums and counts): the CUDA
kernels' wrapper and their plain PyTorch version.

``kmeans_assign`` launches ``csrc/kmeans_assign.cu`` (the Hopper port of
the TPU kernel ``repro/kernels/kmeans_assign.py::kmeans_assign_pallas``)
and only takes fp32 CUDA tensors; ``kmeans_assign_ref`` is the same
function in plain PyTorch (the counterpart of
``repro/kernels/ref.py::kmeans_assign``).  Both return
``(labels int32 (m,), sums fp32 (k,d), counts fp32 (k,))``.

Two variants, one launch each, chosen by ``assign_plan`` from (m, k, d):
``small`` (m <= SMALL_M, the routes: one block, no scratch) and
``stream`` (the Lloyd shape: a persistent grid streaming the rows through
a ring in shared memory, its per-block partials in a scratch cached per
device and stream).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._counts import count_launch
from repro_torch.kernels._rowstream import (
    ALIGN, BARRIER_BYTES, SMEM_PER_BLOCK, padded_stride, ring_plan, sm_count,
    stage_bytes, up16)
from repro_torch.kernels.pairwise_l2 import _check_operands, pairwise_sqdist_ref

# the small variant: one row per thread of one 256-thread block, the rows
# staged in shared memory beside the centers
SMALL_M = 256
GROUP = 16            # blocks whose partials one ticket gathers (kGroup)
# the ring's mbarriers and a flag, and the two mask buffers' full/empty
_BAR_BYTES = BARRIER_BYTES + 32


def kmeans_assign_ref(points: torch.Tensor, centers: torch.Tensor):
    """Nearest-center labels (ties to the lowest index) plus the
    per-cluster sums and counts of the assigned rows, via a one-hot
    contraction."""
    d2 = pairwise_sqdist_ref(points, centers)
    labels = torch.argmin(d2, dim=1).to(torch.int32)
    onehot = torch.nn.functional.one_hot(
        labels.long(), centers.shape[0]).to(torch.float32)
    sums = onehot.T @ points.float()
    counts = torch.sum(onehot, dim=0)
    return labels, sums, counts


@dataclass(frozen=True)
class AssignPlan:
    variant: str          # "small" or "stream"
    d_pad: int            # feature dim the kernel sees (a multiple of 4 for stream)
    rows: int = 0         # rows a tile (stream)
    stages: int = 0       # tiles in flight (stream)
    smem_part: bool = False   # the block's double partial in shared memory
    smem_bytes: int = 0


def _small_bytes(m: int, k: int, d: int) -> int:
    """Mirror of ``small_bytes`` in csrc/kmeans_assign.cu."""
    return (up16(4 * k * d) + up16(4 * k) + up16(4 * (SMALL_M // 32) * k)
            + 4 * m * padded_stride(d))


def _stream_bytes(k: int, d: int, rows: int, stages: int,
                  smem_part: bool) -> int:
    """Mirror of ``stream_layout`` in csrc/kmeans_assign.cu."""
    off = up16(stages * stage_bytes(d, rows) + _BAR_BYTES + 4 * k * d)
    off = up16(off + 4 * k)
    off = up16(off + 4 * 2 * ((rows + 31) // 32) * k)
    off = up16(off + 4 * k)
    if smem_part:
        off = up16(off + 8 * k * d)
    return off + ALIGN


def _too_big(k: int, d: int) -> ValueError:
    return ValueError(
        f"kmeans_assign: centers of shape ({k}, {d}) need {k * d * 4} bytes "
        "of shared memory and leave no room for the rows (a block has "
        "227 KB on an H100)")


@functools.lru_cache(maxsize=256)
def assign_plan(m: int, k: int, d: int) -> AssignPlan:
    """The variant and launch plan for points (m,d) and centers (k,d): a
    pure function of the shapes.  ``small`` where m <= SMALL_M and the
    rows fit in shared memory beside the centers, else ``stream``.
    Raises ValueError when the centers leave no room for the rows."""
    if m <= SMALL_M and _small_bytes(m, k, d) <= SMEM_PER_BLOCK:
        return AssignPlan("small", d, smem_bytes=_small_bytes(m, k, d))
    d_pad = -(-d // 4) * 4
    with_part = ring_plan(lambda r, s: _stream_bytes(k, d_pad, r, s, True))
    without = ring_plan(lambda r, s: _stream_bytes(k, d_pad, r, s, False))
    if without is None:
        raise _too_big(k, d)
    # the partial goes to shared memory only where it costs no ring depth
    part = with_part == without
    rows, stages = without
    return AssignPlan("stream", d_pad, rows, stages, part,
                      _stream_bytes(k, d_pad, rows, stages, part))


_scratch: dict = {}


def _stream_scratch(dev: torch.device, stream: int, grid: int, k: int, d: int):
    """(double partials, int partials, tickets) for one streaming launch,
    kept per (device, stream) and grown as needed.  The tickets are zero
    between launches (the kernel's last block resets them)."""
    ngroups = -(-grid // GROUP)
    nd, ni, nt = (grid + ngroups) * k * d, (grid + ngroups) * k, ngroups + 1
    key = (dev.index, stream)
    held = _scratch.get(key)
    if held is None or held[0].numel() < nd or held[1].numel() < ni:
        held = (torch.empty((nd,), dtype=torch.float64, device=dev),
                torch.empty((ni,), dtype=torch.int32, device=dev),
                held[2] if held is not None else
                torch.zeros((0,), dtype=torch.int32, device=dev))
    if held[2].numel() < nt:
        held = (held[0], held[1],
                torch.zeros((nt,), dtype=torch.int32, device=dev))
    _scratch[key] = held
    return held


def kmeans_assign(points: torch.Tensor, centers: torch.Tensor):
    """Launch the CUDA kernel: points (m,d) and centers (k,d), fp32 CUDA
    tensors -> (labels int32 (m,), sums fp32 (k,d), counts fp32 (k,)),
    on the current stream.  Sums are bit-identical from run to run."""
    _check_operands("kmeans_assign", points, centers)
    m, d = points.shape
    k = centers.shape[0]
    if centers.shape[1] != d:
        raise ValueError(f"kmeans_assign: feature dims differ ({d} vs "
                         f"{centers.shape[1]})")
    if k < 1 or d < 1:
        raise ValueError(f"kmeans_assign needs k >= 1 and d >= 1, got "
                         f"centers of shape ({k}, {d})")
    dev = points.device
    labels = torch.empty((m,), dtype=torch.int32, device=dev)
    if m == 0:
        return (labels, torch.zeros((k, d), dtype=torch.float32, device=dev),
                torch.zeros((k,), dtype=torch.float32, device=dev))
    if m >= 2 ** 31:
        raise ValueError(f"kmeans_assign: {m} rows exceed the kernel's "
                         "32-bit row tiles")
    plan = assign_plan(m, k, d)
    counts = torch.empty((k,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        lib = _build.load("kmeans_assign")
        stream = torch.cuda.current_stream().cuda_stream
        if plan.variant == "small":
            sums = torch.empty((k, d), dtype=torch.float32, device=dev)
            err = lib.kmeans_assign_small_f32(
                points.data_ptr(), centers.data_ptr(), labels.data_ptr(),
                sums.data_ptr(), counts.data_ptr(), m, k, d, stream)
        else:
            if plan.d_pad != d:
                # zero columns change no distance; their sums are dropped
                pad = (0, plan.d_pad - d)
                points = torch.nn.functional.pad(points, pad)
                centers = torch.nn.functional.pad(centers, pad)
            elif points.data_ptr() % 16:
                points = points.clone()      # the bulk copies need 16 bytes
            grid = min(sm_count(dev.index), -(-m // plan.rows))
            dpart, ipart, tickets = _stream_scratch(dev, stream, grid, k,
                                                    plan.d_pad)
            sums = torch.empty((k, plan.d_pad), dtype=torch.float32,
                               device=dev)
            err = lib.kmeans_assign_stream_f32(
                points.data_ptr(), centers.data_ptr(), labels.data_ptr(),
                dpart.data_ptr(), ipart.data_ptr(), tickets.data_ptr(),
                sums.data_ptr(), counts.data_ptr(), m, k, plan.d_pad,
                plan.rows, plan.stages, int(plan.smem_part), grid, stream)
            if plan.d_pad != d:
                sums = sums[:, :d].contiguous()
    _build.check(err, f"kmeans_assign ({plan.variant}) launch at ({m},{d}) "
                 f"x ({k},{d})")
    count_launch(kmeans_assign, plan.variant)
    return labels, sums, counts


kmeans_assign.launches = 0
kmeans_assign.by_variant = {"small": 0, "stream": 0}
