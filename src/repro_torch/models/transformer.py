"""Every architecture family of ``configs/`` in PyTorch: forward, the
training loss, prefill with cache, decode.

The reference assembles every family from one parameter tree with a
leading layer axis consumed by ``jax.lax.scan``; block types (attention
+ MLP, attention + MoE, the xLSTM pair of an mLSTM and an sLSTM block,
the hybrid layer of attention and a selective SSM in parallel) follow
from the ``ModelConfig``, and so do the inputs (token ids, audio frame
embeddings with a masked-frame head, or token ids with image patch
embeddings scattered in).  The port holds one layer per module of an
``nn.ModuleList`` and loops over them.  A layer's module mirrors the
reference's ``init_layer_params`` dict key for key (``ParamTree``), so
the tree layout, the checkpoint keys and the flatten order of the JL
sketch are the reference's.  Leaves keep the reference's dtypes: the
MoE router, the SSM's ``a_log`` and ``d_skip`` stay fp32 in a bf16 model
(``FP32_LEAVES``).

Training works on the reference's parameter TREE instead: a dict with
every layer weight stacked on a leading L axis (``init_tree``,
``tree_from_model``), read through ``model_view`` (per-layer views, no
copies), so a stacked federation of C such trees is C x that layout.
``train_loss`` runs the differentiable attention of
``attention.train_attention``; the serving forward, prefill and decode
run the flash kernel.

Serving state is a ``DecodeCache``: per layer a dict of the family's
state (the attention ring buffers of K and V, (b, hkv, capacity, dh);
the SSM's hidden state and conv window; the xLSTM cells' states) and
the absolute position of the next token, kept on the host as a Python
int.  ``decode_step`` writes the new token's K and V into the ring IN
PLACE (the reference returns new arrays): at full size a copy of every
layer's cache per token would cost more than the step's own work.  The
recurrent states are small and are replaced, as in the reference.

The layers call ``sharding.activations.constrain`` where the reference's
do (and ``constrain_params`` on each layer's weights): identities
outside the dry run's ``activation_sharding`` context, redistributions
of DTensors inside it.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import recurrent as rec
from repro_torch.models.layers import (
    _dense_init,
    cross_entropy_loss,
    embed_init,
    init_mlp,
    mlp_forward,
    rms_norm,
)
from repro_torch.sharding.activations import (
    chunk_last,
    constrain,
    constrain_params,
    embedding,
    model_divides,
)
from repro_torch.utils import tree_map

FRONTEND_DIM = 512     # stub audio frame-embedding dim
PATCH_DIM = 1024       # stub vision patch-embedding dim
# leaves the reference keeps in fp32 at any model dtype (key-path tails)
FP32_LEAVES = ("moe/router", "ssm/a_log", "ssm/d_skip")
# the top-level leaves besides "layers" (each present or not per config)
TOP_LEAVES = ("embed", "final_norm", "lm_head", "frontend_proj",
              "mask_embed", "patch_proj")


class DecodeCache(NamedTuple):
    """Per-layer state dicts + the next token's position."""
    layers: list
    pos: int


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def leaf_dtype(path: str, cfg: ModelConfig) -> torch.dtype:
    """The reference's dtype of the leaf at ``path`` ("/"-joined keys)."""
    return torch.float32 if path.endswith(FP32_LEAVES) else torch_dtype(cfg)


def n_stack(cfg: ModelConfig) -> int:
    """Layer modules: an xLSTM module holds a pair of blocks."""
    return cfg.n_layers // 2 if cfg.block_pattern == "xlstm" else cfg.n_layers


# ============================================================== modules

class ParamTree(nn.Module):
    """A nested dict of tensors as a module: each dict a submodule, each
    tensor a frozen parameter, under the dict's keys."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                setattr(self, key, ParamTree(val))
            else:
                self.register_parameter(
                    key, nn.Parameter(val, requires_grad=False))


def _module_tree(module: nn.Module) -> dict:
    """A ``ParamTree``'s tensors as the nested dict it was built from."""
    out = {name: p for name, p in module.named_parameters(recurse=False)}
    out.update({name: _module_tree(m) for name, m in module.named_children()})
    return out


class Transformer(nn.Module):
    """The parameters of one model (``cfg`` rides along): the top-level
    leaves of ``TOP_LEAVES`` (None where the config has none) and one
    ``ParamTree`` a layer."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__()
        self.cfg = cfg
        for name in TOP_LEAVES:
            t = tree.get(name)
            self.register_parameter(name, None if t is None else
                                    nn.Parameter(t, requires_grad=False))
        self.layers = nn.ModuleList(ParamTree(l) for l in tree["layers"])

    def head(self) -> torch.Tensor:
        """(D, V): the tied embedding's transpose or the LM head."""
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head


# ============================================================== init

def init_layer_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """The parameters of ONE layer (the reference's dict), drawn from
    ``gen``."""
    dtype = torch_dtype(cfg)
    d, dh = cfg.d_model, cfg.resolved_head_dim
    dev = gen.device

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=dev)

    def dense(shape, scale=None):
        return _dense_init(gen, shape, dtype, scale)

    if cfg.block_pattern == "xlstm":
        inner, h = 2 * d, cfg.n_heads
        return {
            "m": {"ln": zeros(d), "w_up": dense((d, 2 * inner)),
                  "w_q": dense((inner, inner)), "w_k": dense((inner, inner)),
                  "w_v": dense((inner, inner)), "w_if": dense((inner, 2 * h)),
                  "b_if": torch.cat([zeros(h), torch.full(
                      (h,), 2.0, dtype=dtype, device=dev)]),
                  "w_down": dense((inner, d))},
            "s": {"ln": zeros(d), "w_zifo": dense((d, 4 * d)),
                  "b_zifo": zeros(4 * d), "w_out": dense((d, d))}}

    p: dict = {"ln1": zeros(d), "attn": {
        "wq": dense((d, cfg.n_heads * dh)),
        "wk": dense((d, cfg.n_kv_heads * dh)),
        "wv": dense((d, cfg.n_kv_heads * dh)),
        "wo": dense((cfg.n_heads * dh, d))}}
    if cfg.qkv_bias:
        p["attn"].update(bq=zeros(cfg.n_heads * dh),
                         bk=zeros(cfg.n_kv_heads * dh),
                         bv=zeros(cfg.n_kv_heads * dh))
    if cfg.block_pattern == "hybrid":
        di, n, r = d, cfg.ssm_state, max(16, d // 64)
        states = torch.arange(1, n + 1, dtype=torch.float32, device=dev)
        p["ssm"] = {
            "w_in": dense((d, 2 * di)),
            "conv_w": dense((cfg.conv_width, di), scale=0.5),
            "w_xdb": dense((di, r + 2 * n)),
            "w_dt": dense((r, di)),
            "b_dt": torch.full((di,), -4.6, dtype=dtype, device=dev),
            "a_log": torch.log(states).repeat(di, 1),
            "d_skip": torch.ones((di,), dtype=torch.float32, device=dev),
            "w_out": dense((di, d))}
        p["beta_attn"] = zeros(d)
        p["beta_ssm"] = zeros(d)
    p["ln2"] = zeros(d)
    if cfg.is_moe:
        p["moe"] = moe_lib.init_moe(gen, cfg, dtype)
    elif cfg.d_ff > 0:
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, cfg.mlp_variant, dtype,
                            device=dev)
    return p


def init_params(cfg: ModelConfig, *, generator: torch.Generator | None = None,
                seed: int = 0, device=None) -> Transformer:
    """A freshly initialised model on ``device`` (CUDA unless "cpu"),
    drawn from ``generator`` (default: one on ``device`` seeded with
    ``seed``).  Same shapes, scales and dtypes as the reference's init,
    not its values."""
    dev = resolve_device(device)
    gen = generator or torch.Generator(device=dev).manual_seed(seed)
    dtype = torch_dtype(cfg)
    tree = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
            "layers": [init_layer_params(gen, cfg)
                       for _ in range(n_stack(cfg))]}
    tree.update(init_params_top(gen, cfg))
    return Transformer(cfg, tree).to(dev)


def init_params_top(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """The top-level leaves after the embedding and the layers, drawn in
    this order: the LM head, the input projection, the final norm."""
    dtype = torch_dtype(cfg)
    tree = {}
    if not cfg.tie_embeddings:
        tree["lm_head"] = _dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                      dtype)
    if cfg.input_mode == "embeddings":
        tree["frontend_proj"] = _dense_init(gen, (FRONTEND_DIM, cfg.d_model),
                                            dtype)
        tree["mask_embed"] = torch.zeros((cfg.d_model,), dtype=dtype,
                                         device=gen.device)
    elif cfg.input_mode == "multimodal":
        tree["patch_proj"] = _dense_init(gen, (PATCH_DIM, cfg.d_model), dtype)
    tree["final_norm"] = torch.zeros((cfg.d_model,), dtype=dtype,
                                     device=gen.device)
    return tree


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree of ``cfg`` (the reference's layout and dtypes:
    layer weights stacked on L) as ``device="meta"`` tensors: shapes and
    dtypes, nothing allocated.  One layer is traced under a fake-tensor
    mode for its shapes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        gen = torch.Generator(device="cpu")
        layer = init_layer_params(gen, cfg)
        top = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model,
                                   torch_dtype(cfg)),
               **init_params_top(gen, cfg)}

    def meta(t, lead=()):
        return torch.empty(lead + tuple(t.shape), dtype=t.dtype,
                           device="meta")

    tree = {k: meta(v) for k, v in top.items()}
    tree["layers"] = tree_map(lambda t: meta(t, (n_stack(cfg),)), layer)
    return tree


# ============================================================ forward

def embed_inputs(model, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """The (b, s, D) input sequence for any input mode: token ids; audio
    frames (b, s, FRONTEND_DIM) through ``frontend_proj`` with the masked
    frames replaced by ``mask_embed``; token ids with patch embeddings
    (b, P, PATCH_DIM) through ``patch_proj`` written at
    ``patch_positions`` (b, P) (distinct positions a row).  Frames and
    patch embeddings are cast to their projection's dtype first."""
    if cfg.input_mode == "tokens":
        return embedding(model.embed, batch["tokens"])
    if cfg.input_mode == "embeddings":
        proj = model.frontend_proj
        x = batch["frames"].to(proj.dtype) @ proj
        if "mask" in batch:
            x = torch.where(batch["mask"][..., None], model.mask_embed, x)
        return x
    if cfg.input_mode == "multimodal":
        x = embedding(model.embed, batch["tokens"])
        proj = model.patch_proj
        patches = batch["patch_embeds"].to(proj.dtype) @ proj
        rows = torch.arange(x.shape[0], device=x.device)[:, None]
        return x.index_put((rows, batch["patch_positions"]),
                           patches.to(x.dtype))
    raise ValueError(cfg.input_mode)


def _qkv_rope(attn, h: torch.Tensor, cfg: ModelConfig,
              positions: torch.Tensor):
    q, k, v = attn_lib.qkv_proj(attn, h, cfg)
    q = attn_lib.rope_transpose(q, positions, cfg.rope_theta)
    k = attn_lib.rope_transpose(k, positions, cfg.rope_theta)
    return q, k, v


def _ssm_branch(lp, h: torch.Tensor, cfg: ModelConfig):
    """Returns (y, (final ssm_h, trailing conv state))."""
    sp = lp.ssm
    n, r = cfg.ssm_state, sp.w_dt.shape[0]
    xs, z = chunk_last(h @ sp.w_in, 2)
    xs, conv_state = rec.causal_conv1d(xs, sp.conv_w)
    xs = F.silu(xs)
    dt_r, bmat, cmat = torch.split(xs @ sp.w_xdb, [r, n, n], dim=-1)
    dt = dt_r @ sp.w_dt + sp.b_dt
    y, final_h = rec.ssm_scan(xs, dt, bmat, cmat, sp.a_log, sp.d_skip,
                              chunk=cfg.ssm_chunk)
    return (y * F.silu(z)) @ sp.w_out, (final_h, conv_state)


def _mlstm_block(mp, x: torch.Tensor, cfg: ModelConfig):
    b, s, _ = x.shape
    hh = cfg.n_heads
    inner = mp.w_down.shape[0]
    xm, gate = chunk_last(rms_norm(x, mp.ln, cfg.norm_eps) @ mp.w_up, 2)

    def heads(w):
        return attn_lib.split_heads(xm @ w, hh)

    gates = xm @ mp.w_if + mp.b_if
    mchunk = s if cfg.mlstm_chunk <= 0 else min(cfg.mlstm_chunk, s)
    out, mstate = rec.mlstm_chunkwise(
        heads(mp.w_q), heads(mp.w_k), heads(mp.w_v),
        gates[..., :hh].transpose(1, 2), gates[..., hh:].transpose(1, 2),
        chunk=mchunk)
    out = attn_lib.merge_heads(out).to(x.dtype)
    return (out * F.silu(gate)) @ mp.w_down, mstate


def _slstm_block(sp, x: torch.Tensor, cfg: ModelConfig):
    zifo = rms_norm(x, sp.ln, cfg.norm_eps) @ sp.w_zifo + sp.b_zifo
    h, sstate = rec.slstm_scan(*chunk_last(zifo, 4))
    return h.to(x.dtype) @ sp.w_out, sstate


def _layer_forward(lp, x: torch.Tensor, cfg: ModelConfig,
                   positions: torch.Tensor, attention=attn_lib.attention,
                   collect_cache: bool = False):
    """One layer.  Returns (x, aux loss or None, the layer's cache parts
    or None).  ``attention`` is the flash kernel's (serving) or
    ``train_attention``."""
    # residual stream sharded (batch over data, d_model over model)
    x = constrain(x, "batch", None, "model")
    cache = None
    if cfg.block_pattern == "xlstm":
        m_out, mstate = _mlstm_block(lp.m, x, cfg)
        x = x + m_out
        s_out, sstate = _slstm_block(lp.s, x, cfg)
        if collect_cache:
            cache = {"m_c": mstate.c, "m_n": mstate.n,
                     "s_c": sstate.c, "s_n": sstate.n}
        return x + s_out, None, cache
    hybrid = cfg.block_pattern == "hybrid"
    h = rms_norm(x, lp.ln1, cfg.norm_eps)
    q, k, v = (constrain(t, "batch", "heads", None, None)
               for t in attn_lib.qkv_proj(lp.attn, h, cfg))
    q = attn_lib.rope_transpose(q, positions, cfg.rope_theta)
    k = attn_lib.rope_transpose(k, positions, cfg.rope_theta)
    o = attention(q, k, v, causal=cfg.causal, window=cfg.window,
                  chunk=cfg.attn_chunk)
    if not hybrid:
        o = constrain(o, "batch", "heads", None, None)
    a_out = attn_lib.out_proj(lp.attn, o)
    if not hybrid:
        a_out = constrain(a_out, "batch", None, None)
    if collect_cache:
        cache = {"k": k, "v": v}
    if hybrid:
        s_out, (ssm_h, conv_state) = _ssm_branch(lp, h, cfg)
        if collect_cache:
            cache.update(ssm_h=ssm_h, conv=conv_state)
        x = x + 0.5 * (rms_norm(a_out, lp.beta_attn, cfg.norm_eps)
                       + rms_norm(s_out, lp.beta_ssm, cfg.norm_eps))
    else:
        x = x + a_out
    h2 = rms_norm(x, lp.ln2, cfg.norm_eps)
    aux = None
    if cfg.is_moe:
        y, aux = moe_lib.moe_forward(lp.moe, h2, cfg)
        x = x + y
    elif cfg.d_ff > 0:
        x = x + mlp_forward(lp.mlp, h2, cfg.mlp_variant)
    return x, aux, cache


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device).expand(b, s)


def _sum_aux(auxs: list, device) -> torch.Tensor:
    total = torch.zeros((), dtype=torch.float32, device=device)
    for a in auxs:
        if a is not None:
            total = total + a
    return total


def _logits(model, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The final norm and the LM head: (b, s, V) logits.  d_model is
    gathered before the vocab-sharded head, whose matmul then needs no
    collective (else DTensor may make full-vocab partial logits)."""
    x = constrain(rms_norm(x, model.final_norm, cfg.norm_eps),
                  "batch", None, None)
    return constrain(x @ model.head(), "batch", None, "vocab")


def forward(model, cfg: ModelConfig, batch: dict, *,
            attention=attn_lib.attention):
    """Full-sequence forward (serving: flash attention; pass
    ``attention=attention.train_attention`` for the plain path).  Returns
    (logits (b, s, V), the summed MoE aux loss, 0 without experts)."""
    x = constrain(embed_inputs(model, cfg, batch), "batch", None, "model")
    positions = _positions(x.shape[0], x.shape[1], x.device)
    auxs = []
    for lp in model.layers:
        x, aux, _ = _layer_forward(constrain_params(lp), x, cfg, positions,
                                   attention)
        auxs.append(aux)
    logits = _logits(model, cfg, x)
    return logits, _sum_aux(auxs, x.device)


# ============================================================ training

REMAT_NAMES = ("none", "full", "dots")


def _train_forward(model, cfg: ModelConfig, batch: dict, remat: str):
    """(logits, summed aux loss) of the training forward:
    ``train_attention``, each layer recomputed in the backward pass under
    remat "full" or "dots" (both ``torch.utils.checkpoint``: PyTorch has
    no policy that keeps the matmul outputs alone, and every name gives
    the same loss and gradients)."""
    if remat not in REMAT_NAMES:
        raise ValueError(f"unknown remat policy {remat!r}")
    x = constrain(embed_inputs(model, cfg, batch), "batch", None, "model")
    positions = _positions(x.shape[0], x.shape[1], x.device)
    auxs = []
    for lp in model.layers:
        def layer(x, lp=lp):
            return _layer_forward(constrain_params(lp), x, cfg, positions,
                                  attn_lib.train_attention)[:2]

        x, aux = layer(x) if remat == "none" else checkpoint(
            layer, x, use_reentrant=False)
        auxs.append(aux)
    logits = _logits(model, cfg, x)
    return logits, _sum_aux(auxs, x.device)


def train_loss(params: dict, cfg: ModelConfig, batch: dict, *,
               remat: str = "none") -> torch.Tensor:
    """The training loss of one model (the reference's parameter tree) on
    ``batch``: mean next-token cross entropy over ``labels`` (audio: over
    the frames of ``mask``, masked-frame prediction), plus the summed MoE
    aux loss."""
    logits, aux = _train_forward(model_view(params, cfg), cfg, batch, remat)
    mask = batch.get("mask") if cfg.input_mode == "embeddings" else None
    return cross_entropy_loss(logits, batch["labels"], mask) + aux


# ======================================================= parameter trees

def _layer_view(lay: dict, i: int) -> SimpleNamespace:
    return SimpleNamespace(**{
        k: _layer_view(v, i) if isinstance(v, dict) else v[i]
        for k, v in lay.items()})


class TreeModel:
    """A parameter tree in the reference's layout seen as the serving
    code's model: the top-level leaves (None where absent), per-layer
    views (``ln1``, ``attn.wq``, ``moe.router`` ...), ``head()``.  Every
    attribute is a view of the tree's tensors: nothing is copied.  A
    layer weight may also be a list of L per-layer tensors (how the
    training step differentiates them)."""

    def __init__(self, params: dict, cfg: ModelConfig):
        self.cfg = cfg
        for name in TOP_LEAVES:
            setattr(self, name, constrain_params(params.get(name)))
        lay = params["layers"]
        first = lay
        while isinstance(first, dict):
            first = first[next(iter(first))]
        self.layers = [_layer_view(lay, i) for i in range(len(first))]

    def head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head


def model_view(params: dict, cfg: ModelConfig) -> TreeModel:
    """The serving/training model over a single-model parameter tree."""
    return TreeModel(params, cfg)


def tree_from_model(model: Transformer) -> dict:
    """A ``Transformer``'s parameters in the reference's tree layout (each
    layer weight stacked on a leading L axis; a copy)."""
    tree = {name: getattr(model, name).detach().clone()
            for name in TOP_LEAVES if getattr(model, name) is not None}
    tree["layers"] = tree_map(lambda *ls: torch.stack([l.detach()
                                                       for l in ls]),
                              *[_module_tree(lp) for lp in model.layers])
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


def prefill_with_cache(model, cfg: ModelConfig, batch: dict,
                       capacity: int | None = None, *,
                       attention=attn_lib.attention):
    """Forward over the prompt AND build the decode cache in one pass.

    Returns (logits (b,s,V), DecodeCache at pos = s).  ``capacity`` is
    the ring-buffer size (>= prompt length for full-cache serving; the
    window for sliding-window serving).  The serve window, if any, also
    applies to the prompt pass, so prefill logits match window-limited
    decode exactly.  K and V go to the rings; the xLSTM and SSM states
    pass through as the prompt left them.
    """
    if cfg.serve_window is not None:
        cfg = dataclasses.replace(cfg, window=cfg.serve_window)
    x = constrain(embed_inputs(model, cfg, batch), "batch", None, "model")
    b, s, _ = x.shape
    if capacity is None:
        capacity = s if cfg.serve_window is None else min(s, cfg.serve_window)
    positions = _positions(b, s, x.device)
    layers = []
    for lp in model.layers:
        x, _, cache = _layer_forward(constrain_params(lp), x, cfg,
                                     positions, attention,
                                     collect_cache=True)
        if "k" in cache:
            cache.update(k=to_ring(cache["k"], capacity),
                         v=to_ring(cache["v"], capacity))
        layers.append(cache)
    logits = _logits(model, cfg, x)
    return logits, DecodeCache(layers=layers, pos=s)


# ============================================================== decode

def init_decode_cache(cfg: ModelConfig, batch: int, context: int,
                      device=None) -> DecodeCache:
    """Zero caches on ``device``: attention rings of capacity
    min(context, serve_window); SSM and xLSTM states of O(1) size."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg)
    dh = cfg.resolved_head_dim
    cap = context if cfg.serve_window is None else min(context,
                                                       cfg.serve_window)

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    def one_layer():
        if cfg.block_pattern == "xlstm":
            dhm = 2 * cfg.d_model // cfg.n_heads
            f32 = torch.float32
            return {"m_c": zeros(batch, cfg.n_heads, dhm, dhm, dt=f32),
                    "m_n": zeros(batch, cfg.n_heads, dhm, dt=f32),
                    "s_c": zeros(batch, cfg.d_model, dt=f32),
                    "s_n": zeros(batch, cfg.d_model, dt=f32)}
        cache = {"k": zeros(batch, cfg.n_kv_heads, cap, dh),
                 "v": zeros(batch, cfg.n_kv_heads, cap, dh)}
        if cfg.block_pattern == "hybrid":
            cache["ssm_h"] = zeros(batch, cfg.d_model, cfg.ssm_state,
                                   dt=torch.float32)
            cache["conv"] = zeros(batch, cfg.conv_width - 1, cfg.d_model)
        return cache

    return DecodeCache(layers=[one_layer() for _ in range(n_stack(cfg))],
                       pos=0)


def _attn_decode(lp, x: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                 pos: int, cfg: ModelConfig):
    """One-token attention over the ring-buffer cache.  x (b,1,D).  Writes
    this token's K/V into slot pos % capacity of kc/vc in place."""
    b = x.shape[0]
    cap = kc.shape[2]
    posv = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
    q, k, v = _qkv_rope(lp, x, cfg, posv)
    slot = pos % cap
    if cfg.splitk_decode:
        # split-K serving: the cache LENGTH dim may be sharded over the
        # model axis, so the ring write is the reference's elementwise
        # select (new rings), never a write at one slot of one shard
        hit = (torch.arange(cap, device=x.device) == slot)[None, None, :,
                                                            None]
        kc = torch.where(hit, k.to(kc.dtype), kc)
        vc = torch.where(hit, v.to(vc.dtype), vc)
    else:
        kc[:, :, slot] = k[:, :, 0].to(kc.dtype)
        vc[:, :, slot] = v[:, :, 0].to(vc.dtype)
    # pin the cache reads: heads (or, split-K, the length) over model
    q = constrain(q, "batch", "heads", None, None)
    if cfg.splitk_decode:
        kc = constrain(kc, "batch", None, "model", None)
        vc = constrain(vc, "batch", None, "model", None)
    else:
        kc = constrain(kc, "batch", "heads", None, None)
        vc = constrain(vc, "batch", "heads", None, None)
    if not model_divides(cfg.n_kv_heads):
        # the query heads' shards do not line up with the KV groups
        q = constrain(q, "batch", None, None, None)
    o = attn_lib.ring_attention(q, kc, vc, pos, cfg, x.dtype)
    return constrain(attn_lib.out_proj(lp, o), "batch", None, None), kc, vc


def _ssm_decode(lp, h: torch.Tensor, cache_l: dict, cfg: ModelConfig):
    """h (b, D) -> (y (b, D), new ssm_h, new conv state)."""
    sp = lp.ssm
    n, r = cfg.ssm_state, sp.w_dt.shape[0]
    xs, z = chunk_last(h @ sp.w_in, 2)
    y1, conv = rec.causal_conv1d(xs[:, None], sp.conv_w,
                                 state=cache_l["conv"])
    xs = F.silu(y1[:, 0])
    dt_r, bvec, cvec = torch.split(xs @ sp.w_xdb, [r, n, n], dim=-1)
    dt = dt_r @ sp.w_dt + sp.b_dt
    y, hh = rec.ssm_decode_step(xs, dt, bvec, cvec, sp.a_log, sp.d_skip,
                                cache_l["ssm_h"])
    return (y * F.silu(z)) @ sp.w_out, hh, conv


def _split_heads_1(x: torch.Tensor, h: int) -> torch.Tensor:
    """(b, h dh) -> (b, h, dh), gathering the flat dim first where ``h``
    does not divide the model axis (as ``attention.split_heads``)."""
    if not model_divides(h):
        x = constrain(x, "batch", None)
    return x.reshape(x.shape[0], h, x.shape[1] // h)


def _xlstm_decode(lp, cache_l: dict, x: torch.Tensor, cfg: ModelConfig):
    b = x.shape[0]
    mp, sp = lp.m, lp.s
    inner = mp.w_down.shape[0]
    hh = cfg.n_heads
    # mLSTM sub-block
    hx = rms_norm(x, mp.ln, cfg.norm_eps)[:, 0]                  # (b, d)
    xm, gate = chunk_last(hx @ mp.w_up, 2)
    q, k, v = (_split_heads_1(xm @ w, hh) for w in (mp.w_q, mp.w_k, mp.w_v))
    gates = xm @ mp.w_if + mp.b_if
    o, mst = rec.mlstm_decode_step(
        q, k, v, gates[:, :hh], gates[:, hh:],
        rec.MLSTMState(c=cache_l["m_c"], n=cache_l["m_n"]))
    o = o.reshape(b, inner).to(x.dtype)
    x = x + ((o * F.silu(gate)) @ mp.w_down)[:, None]
    # sLSTM sub-block
    hx = rms_norm(x, sp.ln, cfg.norm_eps)[:, 0]
    zifo = hx @ sp.w_zifo + sp.b_zifo
    hs, sst = rec.slstm_decode_step(
        *chunk_last(zifo, 4),
        rec.SLSTMState(c=cache_l["s_c"], n=cache_l["s_n"]))
    x = x + (hs.to(x.dtype) @ sp.w_out)[:, None]
    return x, {"m_c": mst.c, "m_n": mst.n, "s_c": sst.c, "s_n": sst.n}


def _layer_decode(lp, cache_l: dict, x: torch.Tensor, pos: int,
                  cfg: ModelConfig):
    """Single-token decode through one layer.  x (b, 1, D)."""
    if cfg.block_pattern == "xlstm":
        return _xlstm_decode(lp, cache_l, x, cfg)
    h = rms_norm(x, lp.ln1, cfg.norm_eps)
    a_out, kc, vc = _attn_decode(lp.attn, h, cache_l["k"], cache_l["v"], pos,
                                 cfg)
    new_cache = {**cache_l, "k": kc, "v": vc}
    if cfg.block_pattern == "hybrid":
        s_out, ssm_h, conv = _ssm_decode(lp, h[:, 0], cache_l, cfg)
        new_cache.update(ssm_h=ssm_h, conv=conv)
        x = x + 0.5 * (rms_norm(a_out, lp.beta_attn, cfg.norm_eps)
                       + rms_norm(s_out[:, None], lp.beta_ssm, cfg.norm_eps))
    else:
        x = x + a_out
    h2 = rms_norm(x, lp.ln2, cfg.norm_eps)
    if cfg.is_moe:
        x = x + moe_lib.moe_forward(lp.moe, h2, cfg)[0]
    elif cfg.d_ff > 0:
        x = x + mlp_forward(lp.mlp, h2, cfg.mlp_variant)
    return x, new_cache


def decode_step(model, cfg: ModelConfig, cache: DecodeCache,
                tokens: torch.Tensor):
    """Decode ONE token.  tokens (b, 1) -> (logits (b,1,V), cache at
    pos + 1).  The returned cache shares (and has updated) the given
    cache's ring buffers; under ``splitk_decode`` it holds new rings."""
    x = embedding(model.embed, tokens)
    pos = int(cache.pos)
    new_layers = []
    for lp, cache_l in zip(model.layers, cache.layers):
        x, cache_l = _layer_decode(constrain_params(lp), cache_l, x, pos, cfg)
        new_layers.append(cache_l)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    return x @ model.head(), DecodeCache(layers=new_layers, pos=pos + 1)
