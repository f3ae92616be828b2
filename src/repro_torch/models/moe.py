"""Mixture-of-Experts layer in PyTorch (the port of ``repro/models/moe.py``):
a top-k router and the per-sequence, gather-only dispatch.

Tokens are routed within each sequence (batch row): the k choices of
every token are sorted by expert id (a stable sort, as ``jnp.argsort``
is, so the tokens a full expert drops are the reference's), each expert
takes at most ``cap`` of them, the experts run as one batched SwiGLU,
and every token gathers its k outputs back, weighted by its
renormalised router probabilities.  Capacity is per sequence, so a
prefill of s tokens can drop tokens that one-token decode never drops.
DeepSeekMoE-style shared experts are an always-on dense SwiGLU.

The dispatch and the expert products are the reference's jnp code, not
Pallas kernels, and stay PyTorch here.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _dense_init, mlp_forward
from repro_torch.sharding.activations import (
    batch_local,
    chunk_last,
    constrain,
)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def capacity(s: int, cfg) -> int:
    """Slots an expert has in a sequence of ``s`` tokens."""
    k, e = cfg.top_k, cfg.n_experts
    return _round_up(max(1, int(s * k / e * cfg.capacity_factor)), 8)


def _top_k(probs: torch.Tensor, k: int):
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    return topv[..., :k], topi[..., :k]


def route(x: torch.Tensor, router: torch.Tensor, k: int):
    """fp32 router: (probs (b, s, e), top-k values and expert ids (b, s,
    k), highest first, ties to the lower expert id as ``lax.top_k`` puts
    them)."""
    logits = x.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    topv, topi = batch_local(functools.partial(_top_k, k=k), probs, n_out=2)
    return probs, topv, topi


def _dispatch(x: torch.Tensor, topi: torch.Tensor, e: int, cap: int):
    """Each sequence's sort-based dispatch: (expert inputs (b, e, cap, D),
    each choice's slot in the flat (e cap) expert outputs (b, s k), and
    whether the choice kept its slot (b, s k))."""
    b, s, d = x.shape
    sk = s * topi.shape[-1]
    rows = torch.arange(b, device=x.device)[:, None]
    flat_eid = topi.reshape(b, sk)
    flat_tok = torch.arange(s, device=x.device).repeat_interleave(
        topi.shape[-1])
    order = torch.argsort(flat_eid, dim=1, stable=True)
    s_eid = torch.gather(flat_eid, 1, order)
    s_tok = flat_tok[order]                                      # (b, sk)
    counts = torch.zeros((b, e), dtype=torch.long, device=x.device)
    counts.scatter_add_(1, flat_eid, torch.ones_like(flat_eid))
    starts = torch.cumsum(counts, dim=1) - counts                # (b, e)

    # expert_in[b, e, c] = x[b, s_tok[starts[e] + c]], masked by c < counts
    slot = torch.arange(cap, device=x.device)
    src = starts[..., None] + slot                               # (b, e, cap)
    valid = (slot < counts[..., None]).reshape(b, e * cap)
    src = torch.clamp(src, 0, sk - 1).reshape(b, e * cap)
    tok_idx = torch.gather(s_tok, 1, src)
    expert_in = x[rows, tok_idx] * valid[..., None].to(x.dtype)

    # where each choice's output lands
    inv_order = torch.empty_like(order)
    inv_order.scatter_(1, order, torch.arange(sk, device=x.device).expand(
        b, sk))
    pos_sorted = torch.arange(sk, device=x.device) - torch.gather(
        starts, 1, s_eid)
    kept_sorted = pos_sorted < cap
    dest_sorted = torch.clamp(s_eid * cap + pos_sorted, 0, e * cap - 1)
    dest = torch.gather(dest_sorted, 1, inv_order)
    kept = torch.gather(kept_sorted, 1, inv_order)
    return expert_in.reshape(b, e, cap, d), dest, kept


def _combine(flat_out: torch.Tensor, dest: torch.Tensor,
             kept: torch.Tensor) -> torch.Tensor:
    """Each choice's expert output (b, s k, D), zero where it was
    dropped."""
    rows = torch.arange(flat_out.shape[0], device=flat_out.device)[:, None]
    return flat_out[rows, dest] * kept[..., None].to(flat_out.dtype)


def _top1_counts(topi: torch.Tensor, e: int) -> torch.Tensor:
    """How many tokens pick each expert first (e,), int64: a scatter-add
    of ones, whose shape (unlike a bincount's) does not depend on the
    values."""
    first = topi[..., 0].reshape(-1)
    counts = torch.zeros((e,), dtype=torch.long, device=topi.device)
    return counts.scatter_add_(0, first, torch.ones_like(first))


def moe_forward(params, x: torch.Tensor, cfg):
    """x (b, s, D) -> (y (b, s, D), aux loss, a 0-d fp32 tensor).  The
    routing, dispatch and combine work a sequence at a time, so on a
    mesh each rank runs them on its own rows (``batch_local``)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    probs, topv, topi = route(x, params.router, k)
    topv = topv / torch.clamp_min(torch.sum(topv, dim=-1, keepdim=True),
                                  1e-9)

    # load-balance auxiliary loss (Switch-style, top-1 counts)
    me = torch.mean(probs, dim=(0, 1))
    ce = batch_local(functools.partial(_top1_counts, e=e), topi,
                     summed=(0,)).float() / (b * s)
    aux = cfg.router_aux_weight * e * torch.sum(me * ce)

    # per-sequence sort-based dispatch
    cap = capacity(s, cfg)
    expert_in, dest, kept = batch_local(
        functools.partial(_dispatch, e=e, cap=cap), x, topi, n_out=3)
    expert_in = constrain(expert_in, "batch", "experts", None, None)

    # expert SwiGLU, batched over experts
    h = torch.einsum("becd,edf->becf", expert_in, params.w_in)
    h = constrain(h, "batch", "experts", None, "model")
    gate, up = chunk_last(h, 2)
    h = F.silu(gate) * up
    expert_out = torch.einsum("becf,efd->becd", h, params.w_out)
    expert_out = constrain(expert_out, "batch", "experts", None, None)

    # combine: each token gathers its k expert outputs
    back = batch_local(_combine, expert_out.reshape(b, e * cap, d), dest,
                       kept)
    w = topv.reshape(b, s * k)[..., None].to(back.dtype)
    y = torch.sum((back * w).reshape(b, s, k, d), dim=2)

    if cfg.n_shared_experts > 0:
        y = y + mlp_forward(params.shared, x, "swiglu")
    return y, aux


def init_moe(gen: torch.Generator, cfg, dtype) -> dict:
    """The MoE parameters: the router in fp32 at any model dtype, the
    experts (and shared experts) in ``dtype``."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    params = {
        "router": _dense_init(gen, (d, e), torch.float32, scale=d ** -0.5),
        "w_in": _dense_init(gen, (e, d, 2 * f), dtype, scale=d ** -0.5),
        "w_out": _dense_init(gen, (e, f, d), dtype, scale=f ** -0.5),
    }
    if cfg.n_shared_experts > 0:
        fs = cfg.n_shared_experts * f
        params["shared"] = {
            "w_in": _dense_init(gen, (d, 2 * fs), dtype, scale=d ** -0.5),
            "w_out": _dense_init(gen, (fs, d), dtype, scale=fs ** -0.5)}
    return params
