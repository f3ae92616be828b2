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

``pairwise_plan`` picks the kernel from the shapes: ``stream`` (k <= 16
and d % 4 == 0: the kmeans++ seeding; rows streamed through a ring in
shared memory), ``tiled`` (every other 2-D call: the kNN tiles and the
fusion tests) and ``batched`` (the tiled kernel over windows).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._counts import count_launch
from repro_torch.kernels._rowstream import (
    ALIGN, BARRIER_BYTES, ring_plan, sm_count, stage_bytes, up16)

STREAM_MAX_K = 16     # centers a consumer thread holds in registers


def _stream_bytes(k: int, d: int, rows: int, stages: int) -> int:
    """Mirror of ``stream_bytes`` in csrc/pairwise_l2.cu."""
    return (up16(stages * stage_bytes(d, rows) + BARRIER_BYTES + 4 * k * d)
            + up16(4 * k) + ALIGN)


@functools.lru_cache(maxsize=256)
def pairwise_plan(m: int, k: int, d: int) -> tuple[str, int, int]:
    """(variant, rows a tile, stages) for a 2-D call (m,d) x (k,d): a pure
    function of the shapes; rows and stages are 0 for the tiled kernel."""
    if k <= STREAM_MAX_K and d % 4 == 0:
        ring = ring_plan(lambda r, s: _stream_bytes(k, d, r, s))
        if ring is not None:
            return ("stream", *ring)
    return ("tiled", 0, 0)


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
    variant, rows, stages = pairwise_plan(m, k, d)
    with torch.cuda.device(a.device):
        lib = _build.load("pairwise_l2")
        stream = torch.cuda.current_stream().cuda_stream
        if variant == "stream":
            if a.data_ptr() % 16:
                a = a.clone()                # the bulk copies need 16 bytes
            sms = sm_count(a.device.index)
            err = lib.pairwise_sqdist_stream_f32(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, d, rows,
                stages, min(sms, -(-m // rows)), stream)
        else:
            err = lib.pairwise_sqdist_f32(a.data_ptr(), b.data_ptr(),
                                          out.data_ptr(), m, k, d, stream)
    _build.check(err, f"pairwise_sqdist ({variant}) launch at ({m},{d}) x "
                 f"({k},{d})")
    count_launch(pairwise_sqdist, variant)
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
    count_launch(pairwise_sqdist, "batched")
    return out


pairwise_sqdist.launches = 0
pairwise_sqdist.by_variant = {"stream": 0, "tiled": 0, "batched": 0}
