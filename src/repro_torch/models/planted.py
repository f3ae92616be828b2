"""Decoder weights whose greedy continuation is known in closed form: a
planted previous-token head.

Random weights make a weak test of a serving path: their top-2 logit
margins are small, and their attention averages over the whole window,
so a wrong cache slot barely moves the output.
``plant_previous_token_head`` rewrites a few tensors of a dense decoder (shapes unchanged) so that
the next token is decided by layer 0's attention reading the cache
entry one position back, with a margin far above bf16 rounding:

  * every token ``t`` gets a sign ``s_t = +-1``, written into embedding
    coordinate 0 at 3x the rms of the embedding's entries;
  * two tokens ``a`` and ``b`` get the embeddings ``+-gamma u`` (plus
    their sign coordinate), ``u`` a unit vector with ``u[0] = 0`` and
    ``gamma`` the embedding's mean row norm.  The LM head is the tied
    embedding, so they win when the final hidden state lies along
    ``+u`` or ``-u``;
  * layer 0, query head 0: its query and key are constant (biases
    only), set so that RoPE puts the score of the key one position back
    ``GAP`` softmax logits above every other key in the window.  Key
    head 0's value is coordinate 0 of the normed input (the token's
    sign), and query head 0 writes it along ``u`` with a gain that
    outweighs the rest of the residual stream.  The other query heads
    of that key head write nothing.

The token after position ``i`` is then ``a`` if the token at ``i - 1``
has sign +1, else ``b``: ``continuation`` computes it on the host.  A
decode that reads the wrong cache slot, a corrupted value, or a
prefill whose attention is off by one position gives other tokens.
Only configurations with query/key/value biases (qwen2) are planted.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

# softmax logits between the previous position's score and the next best
GAP = 40.0
# the planted direction's norm per sqrt(layers x width): the residual
# updates of the other heads and the MLPs are O(sqrt(layers x width))
DOMINANCE = 50.0
# the two tokens the head chooses between
TOKENS = (0, 1)


class PlantedHead(NamedTuple):
    signs: np.ndarray        # (vocab,) int8, +-1
    a: int                   # chosen when the token one back has sign +1
    b: int                   # chosen when it has sign -1
    pairs: int               # RoPE frequency pairs the query/key use
    score_gap: float         # relative score gap over the window


def _rope_pairs(cfg, span: int) -> tuple:
    """The number of leading RoPE pairs whose equal-weight score peaks
    sharpest at distance 1 over distances 0..span, and its relative gap
    (1 - the next best score / the peak)."""
    half = cfg.resolved_head_dim // 2
    freqs = cfg.rope_theta ** (-np.arange(half) / half)
    dist = np.arange(span + 1, dtype=np.float64) - 1.0
    cos = np.cos(np.outer(dist, freqs))
    best = (1, 0.0)
    for k in range(1, half + 1):
        score = cos[:, :k].mean(axis=1)
        gap = 1.0 - np.delete(score, 1).max()
        if gap > best[1]:
            best = (k, gap)
    return best


@torch.no_grad()
def plant_previous_token_head(model, cfg, *, seed: int = 0) -> PlantedHead:
    """Rewrite ``model`` (the port's ``Transformer``) in place as the
    module docstring says.  Returns the signs and the two tokens that
    ``continuation`` needs."""
    if not cfg.qkv_bias:
        raise ValueError(f"{cfg.name} has no qkv biases to plant the "
                         "constant query and key in")
    rng = np.random.default_rng(seed)
    d, dh = cfg.d_model, cfg.resolved_head_dim
    rep = cfg.n_heads // cfg.n_kv_heads
    span = cfg.serve_window or cfg.window or 4096
    a, b = TOKENS
    signs = rng.choice(np.array([-1, 1], np.int8), cfg.vocab_size)
    # two positions after an a comes a b, and after a b an a
    signs[a], signs[b] = -1, 1

    embed = model.embed.float()
    c = 3.0 * float(embed.pow(2).mean().sqrt())
    gamma = float(embed[:, 1:].norm(dim=1).mean())
    u = rng.standard_normal(d)
    u[0] = 0.0
    u /= np.linalg.norm(u)
    ut = torch.as_tensor(u, dtype=torch.float32, device=embed.device)
    embed[a] = gamma * ut
    embed[b] = -gamma * ut
    embed[:, 0] = c * torch.as_tensor(signs, dtype=torch.float32,
                                      device=embed.device)
    model.embed.copy_(embed)

    attn = model.layers[0].attn
    pairs, gap = _rope_pairs(cfg, span)
    r = math.sqrt(GAP * math.sqrt(dh) / (pairs * gap))
    half = dh // 2
    freqs = cfg.rope_theta ** (-np.arange(pairs) / half)
    q = torch.zeros(dh)
    k = torch.zeros(dh)
    # q = R(-theta) k in each pair: the score peaks one position back
    q[:pairs] = torch.as_tensor(r * np.cos(freqs), dtype=torch.float32)
    q[half:half + pairs] = torch.as_tensor(-r * np.sin(freqs),
                                           dtype=torch.float32)
    k[:pairs] = r
    attn.wq[:, :dh] = 0
    attn.bq[:dh] = q.to(attn.bq)
    attn.wk[:, :dh] = 0
    attn.bk[:dh] = k.to(attn.bk)
    attn.wv[:, :dh] = 0
    attn.wv[0, 0] = 1
    attn.bv[:dh] = 0
    # the value is the sign at ~3 (coordinate 0 of a normed embedding)
    gain = DOMINANCE * math.sqrt(cfg.n_layers * d) / 3.0
    attn.wo[:rep * dh] = 0
    attn.wo[0] = (gain * ut).to(attn.wo)
    return PlantedHead(signs=signs, a=int(a), b=int(b), pairs=int(pairs),
                       score_gap=float(gap))


def continuation(tokens, n: int, planted: PlantedHead) -> np.ndarray:
    """The ``n`` greedy tokens after each row of ``tokens`` (b, s >= 2):
    the token after position i is ``a`` when the token at i - 1 has
    sign +1, else ``b``."""
    seq = np.asarray(tokens)
    if seq.ndim != 2 or seq.shape[1] < 2:
        raise ValueError("continuation needs (b, s >= 2) tokens")
    out = []
    for _ in range(n):
        nxt = np.where(planted.signs[seq[:, -2]] > 0, planted.a, planted.b)
        out.append(nxt)
        seq = np.concatenate([seq, nxt[:, None]], axis=1)
    return np.stack(out, axis=1)
