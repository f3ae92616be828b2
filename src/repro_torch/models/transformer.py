"""The dense decoder LM in PyTorch: forward, prefill with cache, decode.

The reference assembles every architecture family from one parameter
tree with a leading layer axis consumed by ``jax.lax.scan``.  The port
holds one ``DecoderLayer`` module per layer in an ``nn.ModuleList`` and
loops over them.  Only the dense attention + MLP blocks over token
inputs are ported; the MoE, xLSTM, hybrid, audio and multimodal
branches raise ``NotImplementedError`` naming the architecture.

Training works on the reference's parameter TREE instead: a dict with
every layer weight stacked on a leading L axis (``init_tree``,
``tree_from_model``), read through ``model_view`` (per-layer views, no
copies), so a stacked federation of C such trees is C x that layout and
its checkpoint keys are the reference's.  ``train_loss`` runs the
differentiable attention of ``attention.train_attention``; the serving
forward, prefill and decode run the flash kernel.

Serving state is a ``DecodeCache``: per layer a ring buffer of K and V
(b, hkv, capacity, dh) and the absolute position of the next token, kept
on the host as a Python int.  ``decode_step`` writes the new token's K
and V into the ring IN PLACE (the reference returns new arrays): at
full size a copy of every layer's cache per token would cost more than
the step's own work.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import (
    MLP,
    _dense_init,
    cross_entropy_loss,
    embed_init,
    init_mlp,
    mlp_forward,
    rms_norm,
)


class DecodeCache(NamedTuple):
    """Per-layer ``{"k", "v"}`` ring buffers + the next token's position."""
    layers: list
    pos: int


def require_ported(cfg: ModelConfig) -> None:
    """Raise for the architecture families the port does not run yet."""
    if (cfg.arch_type != "dense" or cfg.is_moe or cfg.block_pattern != "attn"
            or cfg.input_mode != "tokens"):
        raise NotImplementedError(
            f"{cfg.name} ({cfg.arch_type}, {cfg.block_pattern} blocks, "
            f"{cfg.input_mode} input) is not ported to repro_torch yet; "
            "only dense decoders over tokens are")


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ============================================================== modules

class DecoderLayer(nn.Module):
    """One dense block: ln1, GQA attention, ln2, gated MLP."""

    def __init__(self, ln1: torch.Tensor, attn: attn_lib.Attention,
                 ln2: torch.Tensor, mlp: MLP):
        super().__init__()
        self.ln1 = nn.Parameter(ln1, requires_grad=False)
        self.attn = attn
        self.ln2 = nn.Parameter(ln2, requires_grad=False)
        self.mlp = mlp


class Transformer(nn.Module):
    """The parameters of a dense decoder LM (``cfg`` rides along)."""

    def __init__(self, cfg: ModelConfig, embed: torch.Tensor, layers,
                 final_norm: torch.Tensor,
                 lm_head: torch.Tensor | None = None):
        super().__init__()
        require_ported(cfg)
        self.cfg = cfg
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.layers = nn.ModuleList(layers)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.lm_head = (None if lm_head is None
                        else nn.Parameter(lm_head, requires_grad=False))

    def head(self) -> torch.Tensor:
        """(D, V): the tied embedding's transpose or the LM head."""
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head


# ============================================================== init

def init_layer(gen: torch.Generator, cfg: ModelConfig) -> DecoderLayer:
    """The parameters of ONE dense layer, drawn from ``gen``."""
    dtype = torch_dtype(cfg)
    d, dh = cfg.d_model, cfg.resolved_head_dim
    dev = gen.device

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=dev)

    wq = _dense_init(gen, (d, cfg.n_heads * dh), dtype)
    wk = _dense_init(gen, (d, cfg.n_kv_heads * dh), dtype)
    wv = _dense_init(gen, (d, cfg.n_kv_heads * dh), dtype)
    wo = _dense_init(gen, (cfg.n_heads * dh, d), dtype)
    biases = ((zeros(cfg.n_heads * dh), zeros(cfg.n_kv_heads * dh),
               zeros(cfg.n_kv_heads * dh)) if cfg.qkv_bias else ())
    attn = attn_lib.Attention(wq, wk, wv, wo, *biases)
    mlp = init_mlp(gen, d, cfg.d_ff, cfg.mlp_variant, dtype)
    return DecoderLayer(zeros(d), attn, zeros(d), mlp)


def init_params(cfg: ModelConfig, *, generator: torch.Generator | None = None,
                seed: int = 0, device=None) -> Transformer:
    """A freshly initialised model on ``device`` (CUDA unless "cpu"),
    drawn from ``generator`` (default: one on ``device`` seeded with
    ``seed``).  Same shapes and scales as the reference's init, not its
    values."""
    require_ported(cfg)
    dev = resolve_device(device)
    gen = generator or torch.Generator(device=dev).manual_seed(seed)
    dtype = torch_dtype(cfg)
    embed = embed_init(gen, cfg.vocab_size, cfg.d_model, dtype)
    layers = [init_layer(gen, cfg) for _ in range(cfg.n_layers)]
    lm_head = (None if cfg.tie_embeddings else
               _dense_init(gen, (cfg.d_model, cfg.vocab_size), dtype))
    final_norm = torch.zeros((cfg.d_model,), dtype=dtype, device=gen.device)
    return Transformer(cfg, embed, layers, final_norm, lm_head).to(dev)


# ============================================================ forward

def embed_inputs(model: Transformer, cfg: ModelConfig,
                 batch: dict) -> torch.Tensor:
    """The (b, s, D) input sequence (token inputs only)."""
    return model.embed[batch["tokens"]]


def _attn_block(lp: DecoderLayer, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, attention=attn_lib.attention):
    h = rms_norm(x, lp.ln1, cfg.norm_eps)
    q, k, v = attn_lib.qkv_proj(lp.attn, h, cfg)
    q = attn_lib.rope_transpose(q, positions, cfg.rope_theta)
    k = attn_lib.rope_transpose(k, positions, cfg.rope_theta)
    o = attention(q, k, v, causal=cfg.causal, window=cfg.window,
                  chunk=cfg.attn_chunk)
    return attn_lib.out_proj(lp.attn, o), (k, v)


def _layer_forward(lp: DecoderLayer, x: torch.Tensor, cfg: ModelConfig,
                   positions: torch.Tensor, attention=attn_lib.attention):
    """One dense layer.  Returns (x, (k, v)) with k/v (b, hkv, s, dh).
    ``attention`` is the flash kernel's (serving) or ``train_attention``."""
    a_out, kv = _attn_block(lp, x, cfg, positions, attention)
    x = x + a_out
    h2 = rms_norm(x, lp.ln2, cfg.norm_eps)
    return x + mlp_forward(lp.mlp, h2, cfg.mlp_variant), kv


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device).expand(b, s)


def forward(model: Transformer, cfg: ModelConfig, batch: dict):
    """Full-sequence forward (serving: flash attention).  Returns
    (logits (b,s,V), aux_loss = 0)."""
    x = embed_inputs(model, cfg, batch)
    positions = _positions(x.shape[0], x.shape[1], x.device)
    for lp in model.layers:
        x, _ = _layer_forward(lp, x, cfg, positions)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    return x @ model.head(), torch.zeros((), dtype=torch.float32,
                                         device=x.device)


# ============================================================ training

REMAT_NAMES = ("none", "full", "dots")


def _train_forward(model, cfg: ModelConfig, batch: dict,
                   remat: str) -> torch.Tensor:
    """Logits of the training forward: ``train_attention``, each layer
    recomputed in the backward pass under ``remat`` "full" or "dots"
    (both ``torch.utils.checkpoint``: PyTorch has no policy that keeps
    the matmul outputs alone, and every name gives the same loss and
    gradients)."""
    if remat not in REMAT_NAMES:
        raise ValueError(f"unknown remat policy {remat!r}")
    x = embed_inputs(model, cfg, batch)
    positions = _positions(x.shape[0], x.shape[1], x.device)
    for lp in model.layers:
        def layer(x, lp=lp):
            return _layer_forward(lp, x, cfg, positions,
                                  attn_lib.train_attention)[0]

        x = layer(x) if remat == "none" else checkpoint(
            layer, x, use_reentrant=False)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    return x @ model.head()


def train_loss(params: dict, cfg: ModelConfig, batch: dict, *,
               remat: str = "none") -> torch.Tensor:
    """Mean next-token cross entropy of one model (the reference's
    parameter tree) on ``batch`` ({"tokens", "labels"} (b, s)), plus the
    dense model's aux loss of 0."""
    logits = _train_forward(model_view(params, cfg), cfg, batch, remat)
    return cross_entropy_loss(logits, batch["labels"])


# ======================================================= parameter trees

ATTN_WEIGHTS = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")


class TreeModel:
    """A parameter tree in the reference's layout seen as the serving
    code's model: ``embed``, per-layer views (``ln1``, ``attn.wq`` ...),
    ``final_norm``, ``head()``.  Every attribute is a view of the tree's
    tensors: nothing is copied.  A layer weight may also be a list of L
    per-layer tensors (how the training step differentiates them)."""

    def __init__(self, params: dict, cfg: ModelConfig):
        require_ported(cfg)
        self.cfg = cfg
        self.embed = params["embed"]
        self.final_norm = params["final_norm"]
        self.lm_head = params.get("lm_head")
        lay = params["layers"]
        self.layers = [
            SimpleNamespace(
                ln1=lay["ln1"][i], ln2=lay["ln2"][i],
                attn=SimpleNamespace(**{
                    n: lay["attn"][n][i] if n in lay["attn"] else None
                    for n in ATTN_WEIGHTS}),
                mlp=SimpleNamespace(w_in=lay["mlp"]["w_in"][i],
                                    w_out=lay["mlp"]["w_out"][i]))
            for i in range(len(lay["ln1"]))]

    def head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head


def model_view(params: dict, cfg: ModelConfig) -> TreeModel:
    """The serving/training model over a single-model parameter tree."""
    return TreeModel(params, cfg)


def tree_from_model(model: Transformer) -> dict:
    """A ``Transformer``'s parameters in the reference's tree layout (each
    layer weight stacked on a leading L axis; a copy)."""
    layers = list(model.layers)

    def stack(get):
        return torch.stack([get(lp).detach() for lp in layers])

    attn = {n: stack(lambda lp, n=n: getattr(lp.attn, n))
            for n in ATTN_WEIGHTS if getattr(layers[0].attn, n) is not None}
    tree = {"embed": model.embed.detach().clone(),
            "final_norm": model.final_norm.detach().clone(),
            "layers": {"ln1": stack(lambda lp: lp.ln1),
                       "ln2": stack(lambda lp: lp.ln2), "attn": attn,
                       "mlp": {"w_in": stack(lambda lp: lp.mlp.w_in),
                               "w_out": stack(lambda lp: lp.mlp.w_out)}}}
    if model.lm_head is not None:
        tree["lm_head"] = model.lm_head.detach().clone()
    return tree


def init_tree(cfg: ModelConfig, *, generator: torch.Generator | None = None,
              seed: int = 0, device=None) -> dict:
    """A freshly initialised model as a parameter tree: the draws of
    ``init_params`` (same generator, same order), stacked by layer."""
    return tree_from_model(init_params(cfg, generator=generator, seed=seed,
                                       device=device))


def to_ring(kv: torch.Tensor, capacity: int) -> torch.Tensor:
    """(b, hkv, s, dh) -> ring buffer (b, hkv, capacity, dh) holding the
    last min(s, capacity) positions, position p in slot p % capacity."""
    b, hkv, s, dh = kv.shape
    if capacity >= s:
        ring = kv.new_zeros((b, hkv, capacity, dh))
        ring[:, :, :s] = kv
        return ring
    return torch.roll(kv[:, :, s - capacity:], shifts=s % capacity,
                      dims=2).contiguous()


def prefill_with_cache(model: Transformer, cfg: ModelConfig, batch: dict,
                       capacity: int | None = None):
    """Forward over the prompt AND build the decode cache in one pass.

    Returns (logits (b,s,V), DecodeCache at pos = s).  ``capacity`` is
    the ring-buffer size (>= prompt length for full-cache serving; the
    window for sliding-window serving).  The serve window, if any, also
    applies to the prompt pass, so prefill logits match window-limited
    decode exactly.
    """
    if cfg.serve_window is not None:
        cfg = dataclasses.replace(cfg, window=cfg.serve_window)
    x = embed_inputs(model, cfg, batch)
    b, s, _ = x.shape
    if capacity is None:
        capacity = s if cfg.serve_window is None else min(s, cfg.serve_window)
    positions = _positions(b, s, x.device)
    layers = []
    for lp in model.layers:
        x, (k, v) = _layer_forward(lp, x, cfg, positions)
        layers.append({"k": to_ring(k, capacity), "v": to_ring(v, capacity)})
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    return x @ model.head(), DecodeCache(layers=layers, pos=s)


# ============================================================== decode

def init_decode_cache(cfg: ModelConfig, batch: int, context: int,
                      device=None) -> DecodeCache:
    """Zero caches of capacity min(context, serve_window) on ``device``."""
    require_ported(cfg)
    dev = resolve_device(device)
    dh = cfg.resolved_head_dim
    cap = context if cfg.serve_window is None else min(context,
                                                       cfg.serve_window)
    shape = (batch, cfg.n_kv_heads, cap, dh)
    layers = [{"k": torch.zeros(shape, dtype=torch_dtype(cfg), device=dev),
               "v": torch.zeros(shape, dtype=torch_dtype(cfg), device=dev)}
              for _ in range(cfg.n_layers)]
    return DecodeCache(layers=layers, pos=0)


def _attn_decode(lp: attn_lib.Attention, x: torch.Tensor, kc: torch.Tensor,
                 vc: torch.Tensor, pos: int, cfg: ModelConfig):
    """One-token attention over the ring-buffer cache.  x (b,1,D).  Writes
    this token's K/V into slot pos % capacity of kc/vc in place."""
    b = x.shape[0]
    dh = cfg.resolved_head_dim
    cap = kc.shape[2]
    q, k, v = attn_lib.qkv_proj(lp, x, cfg)
    posv = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
    q = attn_lib.rope_transpose(q, posv, cfg.rope_theta)
    k = attn_lib.rope_transpose(k, posv, cfg.rope_theta)
    slot = pos % cap
    kc[:, :, slot] = k[:, :, 0].to(kc.dtype)
    vc[:, :, slot] = v[:, :, 0].to(vc.dtype)
    kpos = attn_lib._ring_positions(pos, cap, x.device)
    valid = (kpos <= pos) & (kpos >= 0)
    if cfg.serve_window is not None:
        valid &= kpos > pos - cfg.serve_window
    # grouped-head GQA reads the cache directly: query head g * rep + r
    # scores against key/value head g, with no repeat of the cache
    rep = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(b, cfg.n_kv_heads, rep, dh).float()
    sc = torch.matmul(qg, kc.float().transpose(-1, -2)) * dh ** -0.5
    sc = sc.masked_fill(~valid, attn_lib.NEG_INF)
    p = torch.softmax(sc, dim=-1)
    o = torch.matmul(p, vc.float())
    o = o.reshape(b, cfg.n_heads, 1, dh).to(x.dtype)
    return attn_lib.out_proj(lp, o), kc, vc


def _layer_decode(lp: DecoderLayer, cache_l: dict, x: torch.Tensor, pos: int,
                  cfg: ModelConfig):
    """Single-token decode through one layer.  x (b, 1, D)."""
    h = rms_norm(x, lp.ln1, cfg.norm_eps)
    a_out, kc, vc = _attn_decode(lp.attn, h, cache_l["k"], cache_l["v"], pos,
                                 cfg)
    x = x + a_out
    h2 = rms_norm(x, lp.ln2, cfg.norm_eps)
    x = x + mlp_forward(lp.mlp, h2, cfg.mlp_variant)
    return x, {**cache_l, "k": kc, "v": vc}


def decode_step(model: Transformer, cfg: ModelConfig, cache: DecodeCache,
                tokens: torch.Tensor):
    """Decode ONE token.  tokens (b, 1) -> (logits (b,1,V), cache at
    pos + 1).  The returned cache shares (and has updated) the given
    cache's buffers."""
    x = model.embed[tokens]
    pos = int(cache.pos)
    new_layers = []
    for lp, cache_l in zip(model.layers, cache.layers):
        x, cache_l = _layer_decode(lp, cache_l, x, pos, cfg)
        new_layers.append(cache_l)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    return x @ model.head(), DecodeCache(layers=new_layers, pos=pos + 1)
