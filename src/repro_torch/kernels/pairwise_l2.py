"""Pairwise squared Euclidean distances: the CUDA kernel's wrapper and
its plain PyTorch version.

``pairwise_sqdist`` launches ``csrc/pairwise_l2.cu`` (the Hopper port of
the TPU kernel ``repro/kernels/pairwise_l2.py::pairwise_sqdist_pallas``)
and only takes fp32 CUDA tensors; ``pairwise_sqdist_ref`` is the same
function in plain PyTorch (the counterpart of ``repro/kernels/ref.py``),
which the CPU path runs and the chip check compares the kernel with.
``kernels/ops.py`` picks between them by the tensor's device.  Both take
2-D operands or 3-D batches of windows, (nb,m,d) x (nb,k,d) ->
(nb,m,k) (the reference ``jax.vmap``s the kernel over such windows).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def pairwise_sqdist_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m,d) x (k,d) -> (m,k) squared distances in fp32, by the expansion
    ||x||^2 + ||y||^2 - 2<x,y> (one matmul), clamped at zero; a batch
    (nb,m,d) x (nb,k,d) -> (nb,m,k) takes one batched matmul."""
    a = a.float()
    b = b.float()
    a2 = torch.sum(a * a, dim=-1, keepdim=True)
    b2 = torch.sum(b * b, dim=-1).unsqueeze(-2)
    return torch.clamp_min(a2 + b2 - 2.0 * (a @ b.transpose(-1, -2)), 0.0)


def _check_operands(name: str, *tensors: torch.Tensor, ndim: int = 2) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name} launches a CUDA kernel; got a tensor "
                             f"on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes float32, got {t.dtype}")
        if t.ndim != ndim:
            raise ValueError(f"{name} takes {ndim}-D operands, got shape "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous operands")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name} operands lie on different devices")


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: a (m,d), b (k,d) fp32 CUDA tensors ->
    (m,k) fp32 squared distances, on the current stream.  3-D operands
    (nb,m,d), (nb,k,d) go to the batched entry point."""
    if a.ndim == 3:
        return _pairwise_sqdist_batched(a, b)
    _check_operands("pairwise_sqdist", a, b)
    if a.shape[1] != b.shape[1]:
        raise ValueError(f"pairwise_sqdist: feature dims differ "
                         f"({a.shape[1]} vs {b.shape[1]})")
    m, d = a.shape
    k = b.shape[0]
    out = torch.empty((m, k), dtype=torch.float32, device=a.device)
    if m == 0 or k == 0:
        return out
    if max(m, k, d) >= 2 ** 31:
        raise ValueError(f"pairwise_sqdist: shape ({m},{d}) x ({k},{d}) "
                         "exceeds the kernel's 32-bit sizes")
    with torch.cuda.device(a.device):
        lib = _build.load("pairwise_l2")
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pairwise_sqdist_f32(a.data_ptr(), b.data_ptr(),
                                      out.data_ptr(), m, k, d, stream)
    _build.check(err, f"pairwise_sqdist launch at ({m},{d}) x ({k},{d})")
    pairwise_sqdist.launches += 1
    return out


def _pairwise_sqdist_batched(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _check_operands("pairwise_sqdist", a, b, ndim=3)
    if a.shape[0] != b.shape[0] or a.shape[2] != b.shape[2]:
        raise ValueError(f"pairwise_sqdist: batches {tuple(a.shape)} and "
                         f"{tuple(b.shape)} disagree on windows or features")
    nb, m, d = a.shape
    k = b.shape[1]
    out = torch.empty((nb, m, k), dtype=torch.float32, device=a.device)
    if nb == 0 or m == 0 or k == 0:
        return out
    if max(m, k, d) >= 2 ** 31 or nb > 65535:
        raise ValueError(f"pairwise_sqdist: {nb} windows of ({m},{d}) x "
                         f"({k},{d}) exceed the kernel's sizes (at most "
                         "65535 windows, one per grid.z)")
    with torch.cuda.device(a.device):
        lib = _build.load("pairwise_l2")
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pairwise_sqdist_batched_f32(a.data_ptr(), b.data_ptr(),
                                              out.data_ptr(), nb, m, k, d,
                                              stream)
    _build.check(err, f"pairwise_sqdist launch at {nb} windows of "
                 f"({m},{d}) x ({k},{d})")
    pairwise_sqdist.launches += 1
    return out


pairwise_sqdist.launches = 0
