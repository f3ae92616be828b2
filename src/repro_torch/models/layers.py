"""Shared neural building blocks in PyTorch.

Weights keep the reference's layout, ``x @ w`` with w (in, out), so the
reference's parameters carry across unchanged (``repro_torch.interop``).
Initial values are drawn from an explicit ``torch.Generator``; they are
not the reference's ``jax.random`` draws.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import unset_fake_temporarily

from repro_torch.device import resolve_device
from repro_torch.sharding.activations import (
    chunk_last,
    constrain,
    gather_last,
    logsumexp_last,
)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in fp32 with the (1 + scale) gain, cast back to x's type."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _rope_freqs(theta: float, half: int, device: torch.device) -> torch.Tensor:
    """exp(-arange(half) * log(theta) / half) in fp32, computed on the CPU
    (so the card and the CPU rotate by the same angles) and copied to
    ``device`` once: a copy from pageable host memory in every layer
    would stall the host until the device caught up.  Computed outside
    any fake-tensor trace (the dry run's), so the cached table is real."""
    with torch.inference_mode(False), unset_fake_temporarily():
        log_theta = torch.log(torch.tensor(theta, dtype=torch.float32))
        freqs = torch.exp(-torch.arange(half, dtype=torch.float32)
                          * (log_theta / half))
        return freqs.to(device)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10_000.0) -> torch.Tensor:
    """Rotary embeddings, half-split (not interleaved).  x (..., s, h, dh),
    positions (..., s)."""
    half = x.shape[-1] // 2
    freqs = _rope_freqs(float(theta), half, x.device)
    angles = positions[..., :, None].float() * freqs      # (..., s, half)
    cos = torch.cos(angles)[..., None, :]                 # (..., s, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp_forward(params, x: torch.Tensor,
                variant: str = "swiglu") -> torch.Tensor:
    """Gated MLP: ``params.w_in`` (D, 2F) packed gate|up (or (D, F)),
    ``params.w_out`` (F, D)."""
    h = x @ params.w_in
    h = constrain(h, *(["batch"] + [None] * (h.ndim - 2) + ["model"]))
    if variant in ("swiglu", "geglu"):
        gate, up = chunk_last(h, 2)
        act = F.silu(gate) if variant == "swiglu" else F.gelu(
            gate, approximate="tanh")
        h = act * up
    else:
        h = F.relu(h)
    return h @ params.w_out


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, variant: str,
             dtype, *, device=None) -> dict:
    """The reference's MLP weights: ``w_in`` (d_model, 2 d_ff) for swiglu
    and geglu (gate|up packed), else (d_model, d_ff), then ``w_out``
    (d_ff, d_model); each drawn from ``gen`` (in that order) with
    ``_dense_init``'s std fan_in^-1/2, in ``dtype``, on ``device`` (CUDA
    unless "cpu"; the draws are made on the generator's device)."""
    dev = resolve_device(device)
    in_cols = 2 * d_ff if variant in ("swiglu", "geglu") else d_ff
    return {"w_in": _dense_init(gen, (d_model, in_cols), dtype).to(dev),
            "w_out": _dense_init(gen, (d_ff, d_model), dtype).to(dev)}


def _dense_init(gen: torch.Generator, shape, dtype,
                scale: float | None = None) -> torch.Tensor:
    fan_in = shape[-2] if len(shape) >= 2 else shape[0]
    std = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * std).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d_model: int,
               dtype) -> torch.Tensor:
    w = torch.randn((vocab, d_model), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * 0.02).to(dtype)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean cross entropy over valid positions, in fp32.  logits (..., V),
    labels (...); with ``mask`` the sum of masked NLL over the mask's
    count (floored at 1)."""
    logits = logits.float()
    logz = logsumexp_last(logits)
    gold = gather_last(logits, labels.long())
    nll = logz - gold
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
