"""Block (flash) attention with an online softmax: the CUDA kernels'
wrapper and their plain PyTorch version.

``flash_attention`` launches ``csrc/flash_attention.cu``, the Hopper port
of the TPU kernel ``repro/kernels/flash_attention.py::
flash_attention_pallas`` (``_flash_kernel``), on CUDA tensors: bfloat16
inputs go to the tensor-core kernel (``wgmma`` with TMA loads; P is split
into two bf16 terms so that P V keeps fp32's accuracy), float32 inputs to
the CUDA-core kernel (fp32 FMAs).  ``flash_attention_ref`` is the same
function in plain PyTorch, which the CPU path runs and the chip check
compares the kernels with.  ``kernels/ops.py`` picks between kernel and
plain version by the tensor's device.

Both compute, for q (b,h,sq,dh) and k/v (b,hkv,skv,dh) with h a multiple
of hkv (query head i reads key/value head i // (h // hkv)):

* logits (q . k) / sqrt(dh) in fp32, query positions offset by skv - sq;
* live keys kpos < skv, and kpos <= qpos if ``causal``, and
  kpos > qpos - window if ``window`` is not None;
* softmax over the live keys with fp32 statistics and fp32 products,
  the output divided by max(l, 1e-30) and cast to q's dtype.

A row with no live key (sq > skv under a causal mask) comes out as zeros,
as in the Pallas kernel; the reference's ``kernels/ref.py`` gives the
mean of v there instead.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._counts import count_launch

NEG_INF = -1e30
MAX_HEAD_DIM = 256          # the widest head of the decoder configs (gemma-2b)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple:
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention takes q (b,h,sq,dh) and k/v "
                         f"(b,hkv,skv,dh), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, dh = q.shape
    _, hkv, skv, dk = k.shape
    if k.shape[0] != b or dk != dh or hkv == 0 or h % hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not "
                         f"match k/v {tuple(k.shape)}")
    return b, h, hkv, sq, skv, dh


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: int | None = None) -> torch.Tensor:
    """q (b,h,sq,dh), k/v (b,hkv,skv,dh) -> (b,h,sq,dh) in q's dtype."""
    b, h, hkv, sq, skv, dh = _shapes(q, k, v)
    rep = h // hkv
    kf, vf = k.float(), v.float()
    if rep > 1:
        kf = kf.repeat_interleave(rep, dim=1)
        vf = vf.repeat_interleave(rep, dim=1)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * (1.0 / math.sqrt(dh))
    qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s.masked_fill_(~mask, NEG_INF)
    # in place: the logits are the largest buffer (3.8 GB at one serving
    # batch row); a row without live keys has m = NEG_INF and p = 0
    s.sub_(s.amax(dim=-1, keepdim=True)).exp_().masked_fill_(~mask, 0.0)
    den = torch.clamp_min(s.sum(dim=-1, keepdim=True), 1e-30)
    return (torch.matmul(s, vf) / den).to(q.dtype)


def tensor_core_operands(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> tuple:
    """q, k, v as the tensor-core kernel reads them: as they are where
    head_dim is a multiple of 16 and TMA can address each tensor in place
    (16-byte aligned base, every (batch, head, seq) stride a positive
    multiple of 8 elements); otherwise all three as zero-padded copies
    whose head_dim is rounded up to 16, each a (b,n,s,dhp) view of a
    contiguous (b,s,n,dhp) buffer.  The zero columns change neither
    product; the caller keeps scale = 1/sqrt(dh) of the true dh and slices
    the output back to dh."""
    dh = q.shape[-1]
    if dh % 16 == 0 and all(
            t.data_ptr() % 16 == 0 and all(st > 0 and st % 8 == 0
                                           for st in t.stride()[:3])
            for t in (q, k, v)):
        return q, k, v
    dhp = -(-dh // 16) * 16
    out = []
    for t in (q, k, v):
        b, n, s, _ = t.shape
        buf = t.new_zeros((b, s, n, dhp))
        buf[..., :dh] = t.transpose(1, 2)
        out.append(buf.transpose(1, 2))
    return tuple(out)


def kernel_launches() -> dict:
    """Launches of each CUDA kernel since the library was loaded, as the
    library counts them: ``{"tensor_core": n, "cuda_core": n}``."""
    counts = (ctypes.c_longlong * 2)()
    _build.load("flash_attention").flash_attention_kernel_launches(counts)
    return {"tensor_core": counts[0], "cuda_core": counts[1]}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """Launch a CUDA kernel on the current stream: q (b,h,sq,dh), k/v
    (b,hkv,skv,dh), float32 or bfloat16 CUDA tensors of one dtype, read
    through their strides (a tensor whose head_dim axis is not contiguous
    is made contiguous first; bf16 ones that TMA cannot read in place are
    padded, see ``tensor_core_operands``) -> (b,h,sq,dh) in q's dtype, a
    view of a (b,sq,h,dh) buffer (of (b,sq,h,dhp) where bf16 operands
    were padded), so that the model's output projection reshapes it
    without a copy.  sq = 0 returns the empty result and skv = 0 zeros
    (no row has a key), both without a launch."""
    b, h, hkv, sq, skv, dh = _shapes(q, k, v)
    for t in (q, k, v):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention launches a CUDA kernel; got "
                             f"a tensor on {t.device}")
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise TypeError(f"flash_attention takes float32 or bfloat16 q, "
                            f"k, v of one dtype, got {q.dtype}, {k.dtype}, "
                            f"{v.dtype}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash_attention operands lie on different devices")
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes head_dim <= {MAX_HEAD_DIM}, "
                         f"got {dh}")
    if window is not None and window < 0:
        raise ValueError(f"flash_attention: window must be >= 0, got "
                         f"{window}")
    if b * h > 65535:
        raise ValueError(f"flash_attention: batch * heads = {b * h} exceeds "
                         "the grid's 65535")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    if q.dtype == torch.bfloat16:
        q, k, v = tensor_core_operands(q, k, v)
    out = torch.empty((b, sq, h, q.shape[-1]), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if b * h * sq == 0:
        return out[..., :dh]
    if skv == 0:
        return out.zero_()[..., :dh]
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:3])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _build.load("flash_attention").flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
        b, h, hkv, sq, skv, q.shape[-1], int(causal),
        -1 if window is None else int(window), 1.0 / math.sqrt(dh),
        _DTYPES[q.dtype], stream)
    _build.check(err, f"flash_attention launch at {tuple(q.shape)} x "
                 f"{tuple(k.shape)} {q.dtype}")
    count_launch(flash_attention)
    return out[..., :dh]


flash_attention.launches = 0
