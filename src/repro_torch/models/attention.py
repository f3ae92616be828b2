"""Attention: GQA projections, block attention, ring-buffer positions.

Serving's prefill (and its full forward) runs ``attention``, which goes
through ``kernels.ops.flash_attention``: the hand-written Hopper kernel
on a CUDA tensor, its plain PyTorch version on a CPU tensor.  The
kernel's tiling replaces both of the reference's jnp paths (the chunked
online-softmax scan and the direct einsum), which compute the same
function.  The kernel has no backward, as the reference's Pallas kernel
has none, so training runs ``train_attention``: the reference's two jnp
paths in plain, differentiable PyTorch, with its dispatch rule.  The
caller's path picks one (``transformer.train_loss`` the second), never a
caught failure.  Decode reads a ring-buffer cache through
``ring_attention``, from the model's step (``transformer._attn_decode``)
and from ``decode_attention``, the reference's one-layer decode API over
a ``KVCache`` ring of its own with no host read (the reference computes
it in jnp, with no Pallas kernel).  On a mesh (the dry run), ``split_heads``
and ``merge_heads`` handle head counts that do not divide the model
axis, and ``train_attention`` runs per (row, head) shard.
"""
from __future__ import annotations

import functools
from collections.abc import Mapping
from types import SimpleNamespace
from typing import NamedTuple, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.layers import rope
from repro_torch.sharding.activations import (
    constrain,
    heads_local,
    hold_layout,
    model_divides,
)

NEG_INF = -1e30


class KVCache(NamedTuple):
    """One layer's ring-buffer cache for ``decode_attention``."""
    k: torch.Tensor       # (b, hkv, capacity, dh) ring buffer
    v: torch.Tensor       # (b, hkv, capacity, dh)
    pos: torch.Tensor     # () int32 on the ring's device: the absolute
    #                       position of the next token


def rope_transpose(x: torch.Tensor, positions: torch.Tensor,
                   theta: float) -> torch.Tensor:
    """Apply RoPE to (b, h, s, dh) given positions (b, s)."""
    return rope(x.transpose(1, 2), positions, theta).transpose(1, 2)


def qkv_proj(params, x: torch.Tensor, cfg) -> tuple:
    """x (b,s,D) -> q (b,h,s,dh), k/v (b,hkv,s,dh): transposed views of
    (b,s,h,dh) buffers.  ``params``: wq (D, h dh), wk/wv (D, hkv dh) and,
    with ``cfg.qkv_bias``, bq/bk/bv."""
    q = x @ params.wq
    k = x @ params.wk
    v = x @ params.wv
    if cfg.qkv_bias:
        q = q + params.bq
        k = k + params.bk
        v = v + params.bv
    return (split_heads(q, cfg.n_heads), split_heads(k, cfg.n_kv_heads),
            split_heads(v, cfg.n_kv_heads))


def split_heads(x: torch.Tensor, h: int) -> torch.Tensor:
    """(b, s, h dh) -> (b, h, s, dh), a transposed view.  Where ``h`` does
    not divide the model axis the flat dim is gathered first: a reshape
    cannot split a dim sharded unevenly."""
    b, s, hd = x.shape
    if not model_divides(h):
        x = constrain(x, "batch", None, None)
    return x.reshape(b, s, h, hd // h).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(b, h, s, dh) -> (b, s, h dh).  Where ``h`` does not divide the
    model axis the flat result's gradient is held unsharded: its way back
    to heads cannot split a sharded flat dim."""
    b, h, s, dh = x.shape
    out = x.transpose(1, 2).reshape(b, s, h * dh)
    return out if model_divides(h) else hold_layout(out)


def out_proj(params, attn_out: torch.Tensor) -> torch.Tensor:
    """(b,h,s,dh) -> (b,s,D)."""
    return merge_heads(attn_out) @ params.wo


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


def _band_mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
               window: Optional[int]) -> torch.Tensor:
    mask = torch.ones((qpos.shape[0], kpos.shape[1]), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def direct_attention(q, k, v, *, causal: bool, window: Optional[int],
                     q_offset: int = 0) -> torch.Tensor:
    """The reference's small-sequence einsum path (``_direct_attention``):
    q (b,h,sq,dh), k/v (b,h,skv,dh), fp32 scores, cast back to q's type."""
    dh = q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * dh ** -0.5
    sq, skv = q.shape[2], k.shape[2]
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(skv, device=q.device)[None, :]
    s = torch.where(_band_mask(qpos, kpos, causal, window), s,
                    torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def chunked_attention(q, k, v, *, causal: bool, window: Optional[int],
                      chunk_q: int, chunk_kv: int) -> torch.Tensor:
    """The reference's online-softmax scan over (q-chunk, kv-chunk) tiles
    (``_chunked_attention``), every tile visited, masked ones included."""
    b, h, s, dh = q.shape
    scale = dh ** -0.5
    neg = torch.tensor(NEG_INF, device=q.device)
    outs = []
    for qi in range(s // chunk_q):
        qblk = q[:, :, qi * chunk_q:(qi + 1) * chunk_q].float()
        qpos = qi * chunk_q + torch.arange(chunk_q, device=q.device)[:, None]
        o = torch.zeros((b, h, chunk_q, dh), dtype=torch.float32,
                        device=q.device)
        m = torch.full((b, h, chunk_q), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, h, chunk_q), dtype=torch.float32, device=q.device)
        for kj in range(s // chunk_kv):
            kblk = k[:, :, kj * chunk_kv:(kj + 1) * chunk_kv].float()
            vblk = v[:, :, kj * chunk_kv:(kj + 1) * chunk_kv].float()
            kpos = kj * chunk_kv + torch.arange(chunk_kv,
                                                device=q.device)[None, :]
            mask = _band_mask(qpos, kpos, causal, window)
            sc = torch.where(mask, torch.matmul(qblk, kblk.transpose(-1, -2))
                             * scale, neg)
            m_new = torch.maximum(m, torch.amax(sc, dim=-1))
            p = torch.where(mask, torch.exp(sc - m_new[..., None]),
                            torch.zeros((), device=q.device))
            alpha = torch.exp(m - m_new)
            l = l * alpha + torch.sum(p, dim=-1)
            o = o * alpha[..., None] + torch.matmul(p, vblk)
            m = m_new
        outs.append((o / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype))
    return torch.cat(outs, dim=2)


def train_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, chunk: int = 1024) -> torch.Tensor:
    """Differentiable GQA attention for training, the reference's
    dispatcher: k/v repeated to the query heads, then the chunked scan
    when sq == skv, sq > 2 chunk and sq % chunk == 0, else the direct
    einsum (``chunk=0`` forces it)."""
    hkv, h = k.shape[1], q.shape[1]
    if h != hkv:
        k = torch.repeat_interleave(k, h // hkv, dim=1)
        v = torch.repeat_interleave(v, h // hkv, dim=1)
    sq, skv = q.shape[2], k.shape[2]
    if chunk > 0 and sq == skv and sq > 2 * chunk and sq % chunk == 0:
        fn = functools.partial(chunked_attention, causal=causal,
                               window=window, chunk_q=chunk, chunk_kv=chunk)
    else:
        fn = functools.partial(direct_attention, causal=causal,
                               window=window, q_offset=q_offset)
    return heads_local(fn, q, k, v)


# ----------------------------------------------------------------- caches

def init_kv_cache(batch: int, n_kv_heads: int, capacity: int, head_dim: int,
                  dtype=torch.bfloat16, pos=0, *, device=None) -> KVCache:
    """A zero ring of ``capacity`` slots at position ``pos`` on ``device``
    (CUDA unless "cpu")."""
    dev = resolve_device(device)
    shape = (batch, n_kv_heads, capacity, head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                   v=torch.zeros(shape, dtype=dtype, device=dev),
                   pos=torch.as_tensor(pos, dtype=torch.int32).to(dev))


def decode_attention(params, x: torch.Tensor, cache: KVCache, cfg, *,
                     rope_theta: Optional[float] = None) -> tuple:
    """Single-token decode over a ring-buffer cache: x (b, 1, D) ->
    (out (b, 1, D), new cache at pos + 1), the reference's numerics.

    ``params``: the layer's attention weights (wq, wk, wv, wo; bq/bk/bv
    with ``cfg.qkv_bias``) as a dict or attributes.  RoPE at ``pos``; this
    token's K and V go to slot ``pos % capacity``; ``ring_attention``
    over the ring, cast to x's dtype, then ``out_proj``.  ``pos`` stays on
    the device (the write is an indexed copy at a device index), so a
    step reads nothing on the host.

    The returned cache shares ``k`` and ``v`` with the one passed in:
    the write is in place, so the ring passed in holds the new token
    too.  Its ``pos`` is a new tensor (the old cache's is unchanged).
    Pass a copy to keep the old ring."""
    if isinstance(params, Mapping):
        params = SimpleNamespace(**params)
    b, capacity = x.shape[0], cache.k.shape[2]
    pos = cache.pos
    theta = rope_theta if rope_theta is not None else cfg.rope_theta
    q, k, v = qkv_proj(params, x, cfg)                  # q (b, h, 1, dh)
    posv = pos.to(torch.int64).expand(b, 1)
    q = rope_transpose(q, posv, theta)
    k = rope_transpose(k, posv, theta)
    slot = torch.remainder(pos, capacity).to(torch.int64).reshape(1)
    cache.k.index_copy_(2, slot, k.to(cache.k.dtype))
    cache.v.index_copy_(2, slot, v.to(cache.v.dtype))
    out = ring_attention(q, cache.k, cache.v, pos, cfg, x.dtype)
    return (out_proj(params, out),
            KVCache(k=cache.k, v=cache.v, pos=pos + 1))


def ring_attention(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                   pos, cfg, dtype) -> torch.Tensor:
    """One query token (b, h, 1, dh) against a ring-buffer cache kc / vc
    (b, hkv, capacity, dh) that already holds it at slot pos % capacity
    (``pos`` an int or a 0-d tensor): a slot is valid where its absolute
    position p has 0 <= p <= pos (and p > pos - serve_window with one);
    query head g * rep + r reads KV head g, with no repeat of the cache;
    fp32 scores and softmax with the invalid slots at NEG_INF.  Returns
    (b, h, 1, dh) in ``dtype``.  The attention of ``decode_attention`` and
    of the model's decode step (``transformer._attn_decode``)."""
    b, dh = q.shape[0], cfg.resolved_head_dim
    kpos = _ring_positions(pos, kc.shape[2], q.device)
    valid = (kpos <= pos) & (kpos >= 0)
    if cfg.serve_window is not None:
        valid &= kpos > pos - cfg.serve_window
    rep = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(b, cfg.n_kv_heads, rep, dh).float()
    sc = torch.matmul(qg, kc.float().transpose(-1, -2)) * dh ** -0.5
    p = torch.softmax(sc.masked_fill(~valid, NEG_INF), dim=-1)
    out = torch.matmul(p, vc.float())
    return out.reshape(b, cfg.n_heads, 1, dh).to(dtype)


def _ring_positions(pos, capacity: int, device=None) -> torch.Tensor:
    """Absolute position stored in each ring slot after writing ``pos``
    (an int, or a 0-d tensor, whose device the result takes)."""
    if isinstance(pos, torch.Tensor):
        device = pos.device
    slots = torch.arange(capacity, device=device)
    cur = pos % capacity
    # slots <= cur hold positions pos - (cur - slot); slots > cur hold
    # positions from the previous wrap: pos - capacity + (slot - cur)
    return torch.where(slots <= cur, pos - (cur - slots),
                       pos - capacity + (slots - cur))
