"""Device dispatch for the hand-written kernels.

A CUDA tensor goes to the kernel (which launches or raises); a CPU
tensor goes to the kernel's plain PyTorch version.  There is no
environment switch and no fallback: the plain version never sees a CUDA
tensor here.  Inputs of any float type are cast to contiguous fp32,
as the reference casts them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import kmeans_assign as _assign
from repro_torch.kernels import pairwise_l2 as _pairwise

WRAPPERS = {"pairwise_sqdist": _pairwise.pairwise_sqdist,
            "kmeans_assign": _assign.kmeans_assign}


def _fp32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m,d) x (k,d) -> (m,k) squared Euclidean distances, fp32."""
    if a.device.type == "cuda":
        return _pairwise.pairwise_sqdist(_fp32(a), _fp32(b))
    if a.device.type == "cpu":
        return _pairwise.pairwise_sqdist_ref(a, b)
    raise ValueError(f"pairwise_sqdist: no kernel for device {a.device}")


def kmeans_assign(points: torch.Tensor, centers: torch.Tensor):
    """Fused Lloyd assign + accumulate: (labels, sums, counts)."""
    if points.device.type == "cuda":
        return _assign.kmeans_assign(_fp32(points), _fp32(centers))
    if points.device.type == "cpu":
        return _assign.kmeans_assign_ref(points, centers)
    raise ValueError(f"kmeans_assign: no kernel for device {points.device}")


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
