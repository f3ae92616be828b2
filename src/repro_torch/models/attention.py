"""Attention: GQA projections, block attention, ring-buffer positions.

Prefill (and the full forward) runs ``attention``, which goes through
``kernels.ops.flash_attention``: the hand-written Hopper kernel on a
CUDA tensor, its plain PyTorch version on a CPU tensor.  The kernel's
tiling replaces both of the reference's jnp paths (the chunked
online-softmax scan and the direct einsum), which compute the same
function.  Decode reads the ring-buffer cache in
``transformer._attn_decode``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.layers import rope

NEG_INF = -1e30


class Attention(nn.Module):
    """GQA projections: wq (D, h dh), wk/wv (D, hkv dh), wo (h dh, D) and,
    with ``qkv_bias``, bq/bk/bv."""

    def __init__(self, wq, wk, wv, wo, bq=None, bk=None, bv=None):
        super().__init__()
        for name, w in (("wq", wq), ("wk", wk), ("wv", wv), ("wo", wo),
                        ("bq", bq), ("bk", bk), ("bv", bv)):
            setattr(self, name, None if w is None
                    else nn.Parameter(w, requires_grad=False))


def rope_transpose(x: torch.Tensor, positions: torch.Tensor,
                   theta: float) -> torch.Tensor:
    """Apply RoPE to (b, h, s, dh) given positions (b, s)."""
    return rope(x.transpose(1, 2), positions, theta).transpose(1, 2)


def qkv_proj(params: Attention, x: torch.Tensor, cfg) -> tuple:
    """x (b,s,D) -> q (b,h,s,dh), k/v (b,hkv,s,dh): transposed views of
    (b,s,h,dh) buffers."""
    b, s, _ = x.shape
    dh = cfg.resolved_head_dim
    q = x @ params.wq
    k = x @ params.wk
    v = x @ params.wv
    if cfg.qkv_bias:
        q = q + params.bq
        k = k + params.bk
        v = v + params.bv
    q = q.reshape(b, s, cfg.n_heads, dh).transpose(1, 2)
    k = k.reshape(b, s, cfg.n_kv_heads, dh).transpose(1, 2)
    v = v.reshape(b, s, cfg.n_kv_heads, dh).transpose(1, 2)
    return q, k, v


def out_proj(params: Attention, attn_out: torch.Tensor) -> torch.Tensor:
    """(b,h,s,dh) -> (b,s,D)."""
    b, h, s, dh = attn_out.shape
    return attn_out.transpose(1, 2).reshape(b, s, h * dh) @ params.wo


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              q_offset: int = 0, chunk: int = 1024) -> torch.Tensor:
    """GQA attention.  q (b,h,sq,dh), k/v (b,hkv,skv,dh) -> (b,h,sq,dh).

    Query i sits at position i + q_offset.  The kernel places it at
    i + (skv - sq), so any other offset raises rather than being guessed.
    ``chunk`` is kept for the reference's signature: the kernel tiles on
    its own.
    """
    del chunk
    sq, skv = q.shape[2], k.shape[2]
    if q_offset != skv - sq:
        raise ValueError(f"attention: q_offset {q_offset} differs from "
                         f"skv - sq = {skv - sq}, which the kernel uses")
    return ops.flash_attention(q, k, v, causal=causal, window=window)


def _ring_positions(pos: int, capacity: int,
                    device=None) -> torch.Tensor:
    """Absolute position stored in each ring slot after writing ``pos``."""
    slots = torch.arange(capacity, device=device)
    cur = pos % capacity
    # slots <= cur hold positions pos - (cur - slot); slots > cur hold
    # positions from the previous wrap: pos - capacity + (slot - cur)
    return torch.where(slots <= cur, pos - (cur - slots),
                       pos - capacity + (slots - cur))
