"""Fused Lloyd step (assign + per-cluster sums and counts): the CUDA
kernel's wrapper and its plain PyTorch version.

``kmeans_assign`` launches ``csrc/kmeans_assign.cu`` (the Hopper port of
the TPU kernel ``repro/kernels/kmeans_assign.py::kmeans_assign_pallas``)
and only takes fp32 CUDA tensors; ``kmeans_assign_ref`` is the same
function in plain PyTorch (the counterpart of
``repro/kernels/ref.py::kmeans_assign``).  Both return
``(labels int32 (m,), sums fp32 (k,d), counts fp32 (k,))``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pairwise_l2 import _check_operands, pairwise_sqdist_ref


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


@functools.lru_cache(maxsize=64)
def _plan(device_index: int, k: int, d: int) -> tuple[int, int, int]:
    """(rows per tile, dynamic shared memory bytes, most useful grid) for
    (k, d) on one device."""
    lib = _build.load("kmeans_assign")
    br, smem, grid = ctypes.c_int(), ctypes.c_longlong(), ctypes.c_int()
    with torch.cuda.device(device_index):
        err = lib.kmeans_assign_plan(k, d, ctypes.byref(br),
                                     ctypes.byref(smem), ctypes.byref(grid))
    if err == 1:       # cudaErrorInvalidValue: the centers fill shared memory
        raise ValueError(
            f"kmeans_assign: centers of shape ({k}, {d}) need {k * d * 4} "
            "bytes of shared memory and leave no room for a tile of points "
            "(a block has 227 KB on an H100)")
    _build.check(err, f"kmeans_assign plan for k={k}, d={d}")
    return br.value, smem.value, grid.value


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
    br, smem, max_grid = _plan(dev.index if dev.index is not None
                               else torch.cuda.current_device(), k, d)
    grid = max(1, min(max_grid, -(-m // br)))
    part_sums = torch.empty((grid, k, d), dtype=torch.float64, device=dev)
    part_counts = torch.empty((grid, k), dtype=torch.int32, device=dev)
    sums = torch.empty((k, d), dtype=torch.float32, device=dev)
    counts = torch.empty((k,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        lib = _build.load("kmeans_assign")
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.kmeans_assign_f32(
            points.data_ptr(), centers.data_ptr(), labels.data_ptr(),
            part_sums.data_ptr(), part_counts.data_ptr(), sums.data_ptr(),
            counts.data_ptr(), m, k, d, br, smem, grid, stream)
    _build.check(err, f"kmeans_assign launch at ({m},{d}) x ({k},{d})")
    kmeans_assign.launches += 1
    return labels, sums, counts


kmeans_assign.launches = 0
