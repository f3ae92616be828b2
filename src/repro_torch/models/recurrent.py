"""Recurrent blocks in PyTorch (the port of ``repro/models/recurrent.py``):
xLSTM (mLSTM + sLSTM) and the Mamba-style selective SSM.

* **mLSTM** runs in the chunkwise-parallel form: within a chunk of W
  tokens the matrix-memory recurrence is a decay-masked attention, and
  only the (C, n) carry between chunks is a loop (S / W steps).
* **sLSTM** is an elementwise recurrence, a loop over time.  Its gates
  are computed for all steps at once; the loop runs the two carries
  (one fused multiply-add each), and the output is formed after it.
* **Selective SSM**: the reference uses ``jax.lax.associative_scan``,
  which PyTorch lacks.  Within a chunk the port runs a log-depth
  doubling scan (Hillis-Steele: log2(W) steps over the whole chunk), so
  a prompt of 8192 tokens takes 32 chunks of 8 steps a layer instead of
  8192 per-token steps.  The doubling scan adds in another order than
  JAX's associative scan, so the two agree to fp32 rounding, not bit for
  bit.

Decode carries O(1) state a layer: mLSTM (C, n), sLSTM (c, n), SSM
(h, conv window).  These are the reference's jnp code, not Pallas
kernels, and stay PyTorch here.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.sharding.activations import per_shard


# ===================================================================== mLSTM

class MLSTMState(NamedTuple):
    c: torch.Tensor   # (b, h, dh, dh) matrix memory
    n: torch.Tensor   # (b, h, dh) normalizer


def mlstm_chunkwise(q, k, v, i_gate, f_gate, *, chunk: int = 256,
                    state: MLSTMState | None = None):
    """Chunkwise-parallel mLSTM.  q/k/v (b, h, s, dh); i_gate/f_gate
    (b, h, s) pre-activations.  Returns (out (b, h, s, dh) fp32, final
    ``MLSTMState``)."""
    b, h, s, dh = q.shape
    w = min(chunk, s)
    if s % w:
        raise ValueError(f"seq {s} not divisible by chunk {w}")
    scale = dh ** -0.5
    logf = per_shard(F.logsigmoid, f_gate.float())               # (b,h,s)
    logi = i_gate.float()
    # the query is scaled in fp32, as the decode step scales it (the
    # reference scales it in the model dtype here; in fp32 the two agree)
    qs = q.float() * scale
    if state is None:
        c_prev = q.new_zeros((b, h, dh, dh), dtype=torch.float32)
        n_prev = q.new_zeros((b, h, dh), dtype=torch.float32)
    else:
        c_prev, n_prev = state.c.float(), state.n.float()
    tri = torch.tril(torch.ones((w, w), dtype=torch.bool, device=q.device))
    outs = []
    for j in range(s // w):
        sl = slice(j * w, (j + 1) * w)
        qb, kb, vb = qs[:, :, sl], k[:, :, sl].float(), v[:, :, sl].float()
        lf, li = logf[:, :, sl], logi[:, :, sl]
        csum = torch.cumsum(lf, dim=-1)                          # (b,h,w)
        total = csum[..., -1]
        # intra-chunk decay d[t, s] = exp(csum_t - csum_s + li_s), s <= t
        dmat = csum[..., :, None] - csum[..., None, :] + li[..., None, :]
        dmat = dmat.masked_fill(~tri, float("-inf"))
        dexp = torch.exp(torch.clamp_max(dmat, 30.0))
        attn = torch.matmul(qb, kb.transpose(-1, -2)) * dexp
        num_intra = torch.matmul(attn, vb)
        den_intra = torch.sum(attn, dim=-1)
        dstart = torch.exp(torch.clamp_max(csum, 30.0))         # (b,h,w)
        num_inter = torch.matmul(qb, c_prev) * dstart[..., None]
        den_inter = torch.matmul(qb, n_prev[..., None])[..., 0] * dstart
        den = torch.clamp_min(torch.abs(den_intra + den_inter), 1.0)
        outs.append((num_intra + num_inter) / den[..., None])
        wdecay = torch.exp(torch.clamp_max(total[..., None] - csum + li,
                                           30.0))
        kw = kb * wdecay[..., None]
        carry = torch.exp(torch.clamp_max(total, 30.0))
        c_prev = carry[..., None, None] * c_prev + torch.matmul(
            kw.transpose(-1, -2), vb)
        n_prev = carry[..., None] * n_prev + torch.sum(kw, dim=2)
    return torch.cat(outs, dim=2), MLSTMState(c=c_prev, n=n_prev)


def mlstm_decode_step(q, k, v, i_gate, f_gate, state: MLSTMState):
    """One-token mLSTM update.  q/k/v (b, h, dh); gates (b, h)."""
    dh = q.shape[-1]
    qf = q.float() * dh ** -0.5
    kf, vf = k.float(), v.float()
    f = torch.exp(F.logsigmoid(f_gate.float()))[..., None]
    i = torch.exp(torch.clamp_max(i_gate.float(), 30.0))[..., None]
    c = f[..., None] * state.c + (i[..., None] * kf[..., :, None]) \
        * vf[..., None, :]
    n = f * state.n + i * kf
    den = torch.clamp_min(torch.abs(torch.sum(qf * n, dim=-1)), 1.0)
    out = torch.matmul(qf[..., None, :], c)[..., 0, :] / den[..., None]
    return out, MLSTMState(c=c, n=n)


# ===================================================================== sLSTM

class SLSTMState(NamedTuple):
    c: torch.Tensor   # (b, d)
    n: torch.Tensor   # (b, d)


def slstm_scan(z, i_gate, f_gate, o_gate, state: SLSTMState | None = None):
    """Elementwise sLSTM over time; every input (b, s, d) pre-activations.
    Returns (h (b, s, d) fp32, final ``SLSTMState``)."""
    b, s, d = z.shape
    # time-major, so each step's row is contiguous
    zf = torch.tanh(z.float()).transpose(0, 1)
    f = torch.exp(per_shard(F.logsigmoid, f_gate.float())).transpose(
        0, 1).contiguous()
    i = torch.exp(torch.clamp_max(i_gate.float(), 30.0)).transpose(0, 1)
    iz = (i * zf).contiguous()
    i = i.contiguous()
    if state is None:
        c = z.new_zeros((b, d), dtype=torch.float32)
        n = z.new_zeros((b, d), dtype=torch.float32)
    else:
        c, n = state.c.float(), state.n.float()
    cs, ns = [], []
    for t in range(s):
        c = torch.addcmul(iz[t], f[t], c)
        n = torch.addcmul(i[t], f[t], n)
        cs.append(c)
        ns.append(n)
    o = torch.sigmoid(o_gate.float())
    ratio = torch.stack(cs, dim=1) / torch.clamp_min(
        torch.abs(torch.stack(ns, dim=1)), 1.0)
    return o * ratio, SLSTMState(c=c, n=n)


def slstm_decode_step(z, i_gate, f_gate, o_gate, state: SLSTMState):
    """One-token sLSTM update; every input (b, d)."""
    zf = torch.tanh(z.float())
    f = torch.exp(F.logsigmoid(f_gate.float()))
    i = torch.exp(torch.clamp_max(i_gate.float(), 30.0))
    o = torch.sigmoid(o_gate.float())
    c = f * state.c + i * zf
    n = f * state.n + i
    h = o * c / torch.clamp_min(torch.abs(n), 1.0)
    return h, SLSTMState(c=c, n=n)


# ================================================================ selective SSM

class SSMState(NamedTuple):
    h: torch.Tensor       # (b, di, n) ssm hidden
    conv: torch.Tensor    # (b, cw-1, di) trailing conv window


def linear_scan(decay: torch.Tensor, add: torch.Tensor) -> torch.Tensor:
    """h_t = decay_t * h_{t-1} + add_t along dim 1 with h_{-1} = 0, by
    log-depth doubling: after the step of offset o, entry t holds the
    recurrence over the o' >= o entries ending at t."""
    a, h = decay, add
    s = h.shape[1]
    off = 1
    while off < s:
        h = torch.cat([h[:, :off], torch.addcmul(h[:, off:], a[:, off:],
                                                 h[:, :-off])], dim=1)
        if off * 2 < s:
            a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return h


def _ssm_assoc(x, dt, bmat, cmat, a_log, d_skip, *, state_h=None):
    """The selective SSM over the full given length (one doubling scan).
    Returns (y in x's dtype, final h (b, di, n) fp32)."""
    a = -torch.exp(a_log.float())                                # (di, n)
    dtf = F.softplus(dt.float())                                 # (b, s, di)
    decay = torch.exp(dtf[..., None] * a)                        # (b,s,di,n)
    add = (dtf * x.float())[..., None] * bmat.float()[..., None, :]
    if state_h is not None:
        # fold the incoming state into the first step's additive term
        add[:, 0] += decay[:, 0] * state_h.float()
    hs = linear_scan(decay, add)
    y = torch.einsum("bsdn,bsn->bsd", hs, cmat.float())
    y = y + d_skip.float() * x.float()
    return y.to(x.dtype), hs[:, -1]


def ssm_scan(x, dt, bmat, cmat, a_log, d_skip, *, state_h=None,
             chunk: int = 0):
    """Selective state-space scan.  x/dt (b, s, di), bmat/cmat (b, s, n),
    a_log (di, n), d_skip (di,).  ``chunk`` > 0 (and s a multiple of it,
    above it) runs s / chunk chunks in turn, each carrying its final
    state into the next, so the (b, s, di, n) expansion never exists at
    once; otherwise one scan over the whole length."""
    b, s, di = x.shape
    if chunk <= 0 or s <= chunk or s % chunk:
        return _ssm_assoc(x, dt, bmat, cmat, a_log, d_skip, state_h=state_h)
    h = (x.new_zeros((b, di, bmat.shape[-1]), dtype=torch.float32)
         if state_h is None else state_h)
    ys = []
    for j in range(s // chunk):
        sl = slice(j * chunk, (j + 1) * chunk)
        y, h = _ssm_assoc(x[:, sl], dt[:, sl], bmat[:, sl], cmat[:, sl],
                          a_log, d_skip, state_h=h)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def ssm_decode_step(x, dt, bvec, cvec, a_log, d_skip, h):
    """One-token SSM update.  x/dt (b, di); bvec/cvec (b, n); h (b, di, n)."""
    a = -torch.exp(a_log.float())
    dtf = F.softplus(dt.float())
    decay = torch.exp(dtf[..., None] * a)
    h = decay * h + (dtf * x.float())[..., None] * bvec.float()[:, None, :]
    y = torch.matmul(h, cvec.float()[..., None])[..., 0]
    y = y + d_skip.float() * x.float()
    return y.to(x.dtype), h


def causal_conv1d(x, w, *, state=None):
    """Depthwise causal conv.  x (b, s, di), w (cw, di).  Returns (y
    (b, s, di), the new trailing state (b, cw-1, di) in x's dtype)."""
    b, s, di = x.shape
    cw = w.shape[0]
    if state is None:
        state = x.new_zeros((b, cw - 1, di))
    xp = torch.cat([state.to(x.dtype), x], dim=1)               # (b,s+cw-1,di)
    y = sum(xp[:, i:i + s] * w[i] for i in range(cw))
    return y, xp[:, s:]
