"""Device dispatch for the hand-written kernels.

A CUDA tensor goes to the kernel (which launches or raises); a CPU
tensor goes to the kernel's plain PyTorch version.  There is no
environment switch and no fallback: the plain version never sees a CUDA
tensor here.  Inputs of the engine kernels are cast to contiguous fp32,
as the reference casts them; ``flash_attention`` takes float32 or
bfloat16 as they come and reads them through their strides (bf16 on the
tensor cores, fp32 on the CUDA cores), so no second copy of q, k and v
is written unless TMA cannot address them in place.

Every call of an engine kernel charges its work
(``roofline/kernel_costs.py``, from the shapes) to the calling thread's
open tallies before it dispatches, so the kernel and the plain version
count the same work.  ``flash_attention`` charges nothing: no engine
program runs it, and a model's step is counted by
``roofline.analysis.model_flops``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _counts
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import group_prox as _prox
from repro_torch.kernels import kmeans_assign as _assign
from repro_torch.kernels import pairwise_l2 as _pairwise
from repro_torch.roofline import kernel_costs as _costs

WRAPPERS = {"pairwise_sqdist": _pairwise.pairwise_sqdist,
            "kmeans_assign": _assign.kmeans_assign,
            "group_ball_proj": _prox.group_ball_proj,
            "group_ball_proj_batched": _prox.group_ball_proj_batched,
            "ama_gather_back": _prox.ama_gather_back,
            "flash_attention": _flash.flash_attention}


def _fp32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m,d) x (k,d) -> (m,k) squared Euclidean distances, fp32; batches
    of windows (nb,m,d) x (nb,k,d) -> (nb,m,k)."""
    nb = a.shape[0] if a.dim() == 3 else 1
    _costs.charge(_costs.pairwise_sqdist(a.shape[-2], b.shape[-2],
                                         a.shape[-1], nb))
    if a.device.type == "cuda":
        return _pairwise.pairwise_sqdist(_fp32(a), _fp32(b))
    if a.device.type == "cpu":
        return _pairwise.pairwise_sqdist_ref(a, b)
    raise ValueError(f"pairwise_sqdist: no kernel for device {a.device}")


def kmeans_assign(points: torch.Tensor, centers: torch.Tensor):
    """Fused Lloyd assign + accumulate: (labels, sums, counts)."""
    _costs.charge(_costs.kmeans_assign(points.shape[0], centers.shape[0],
                                       points.shape[1]))
    if points.device.type == "cuda":
        return _assign.kmeans_assign(_fp32(points), _fp32(centers))
    if points.device.type == "cpu":
        return _assign.kmeans_assign_ref(points, centers)
    raise ValueError(f"kmeans_assign: no kernel for device {points.device}")


def group_ball_proj(v: torch.Tensor, radius) -> torch.Tensor:
    """Row-wise L2-ball projection of v (e,d); radius scalar or (e,)."""
    _costs.charge(_costs.group_ball_proj(v.shape[0], v.shape[1],
                                         _costs.radius_elems(radius)))
    if v.device.type == "cuda":
        return _prox.group_ball_proj(_fp32(v), radius)
    if v.device.type == "cpu":
        return _prox.group_ball_proj_ref(v, radius)
    raise ValueError(f"group_ball_proj: no kernel for device {v.device}")


def group_ball_proj_batched(v: torch.Tensor, radius, *, u=None, i_idx=None,
                            j_idx=None, eta=None,
                            moved=None) -> torch.Tensor:
    """Batched row-wise L2-ball projection of v (b,e,d); radius
    broadcastable to (b,e).  Given the AMA step's operands (``u`` (b,m,d),
    the int32 edge ends ``i_idx``, ``j_idx``, ``eta`` and the 0-d
    ``moved``), v is the dual nu (fp32, contiguous) and the call is one
    fused edge pass that steps it in place: nu = the prox of nu - eta
    (u[:, i] - u[:, j]), ``moved`` = max |new - nu|
    (``group_prox.ama_step_ref``); returns nu."""
    rows, d = v.shape[0] * v.shape[1], v.shape[2]
    r_elems = _costs.radius_elems(radius)
    step = _prox.step_operands(u=u, i_idx=i_idx, j_idx=j_idx, eta=eta,
                               moved=moved)
    _costs.charge(_costs.group_ball_proj(rows, d, r_elems) if step is None
                  else _costs.ama_step(v.shape[0], v.shape[1], u.shape[1], d,
                                       r_elems))
    if v.device.type == "cuda":
        if step is not None:      # in place: nu itself, never a copy
            return _prox.group_ball_proj_batched(v, radius, **step)
        return _prox.group_ball_proj_batched(_fp32(v), radius)
    if v.device.type == "cpu":
        if step is None:
            return _prox.group_ball_proj_batched_ref(v, radius)
        return _prox.ama_step_ref(v, radius, **step)
    raise ValueError(f"group_ball_proj_batched: no kernel for device "
                     f"{v.device}")


def ama_gather_back(a: torch.Tensor, nu: torch.Tensor, heads, tails,
                    u: torch.Tensor) -> torch.Tensor:
    """The AMA's primal from its dual: u (b,m,d) = a (m,d) + (segment sums
    of nu (b,e,d) over the heads' ``SegmentPlan`` - over the tails'),
    each run added in order (the plain version's bits on every run),
    written into ``u`` (fp32, contiguous); returns u."""
    _costs.charge(_costs.ama_gather_back(nu.shape[0], nu.shape[1],
                                         a.shape[0], a.shape[1]))
    if nu.device.type == "cuda":
        return _prox.ama_gather_back(_fp32(a), _fp32(nu), heads, tails, u)
    if nu.device.type == "cpu":
        return _prox.ama_gather_back_ref(a, nu, heads, tails, u)
    raise ValueError(f"ama_gather_back: no kernel for device {nu.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """Block attention: q (b,h,sq,dh), k/v (b,hkv,skv,dh) ->
    (b,h,sq,dh) in q's dtype, query positions offset by skv - sq."""
    if q.device.type == "cuda":
        return _flash.flash_attention(q, k, v, causal=causal, window=window)
    if q.device.type == "cpu":
        return _flash.flash_attention_ref(q, k, v, causal=causal,
                                          window=window)
    raise ValueError(f"flash_attention: no kernel for device {q.device}")


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    with _counts.LOCK:
        return {name: fn.launches for name, fn in WRAPPERS.items()}


def variant_counts() -> dict:
    """Launches per variant since the last reset, for the wrappers that
    pick a kernel by shape or by their operands (``kmeans_assign``: small
    / stream; ``pairwise_sqdist``: stream / tiled / batched;
    ``group_ball_proj_batched``: plain / ama_step)."""
    with _counts.LOCK:
        return {name: dict(fn.by_variant) for name, fn in WRAPPERS.items()
                if hasattr(fn, "by_variant")}


def reset_launch_counts() -> None:
    with _counts.LOCK:
        for fn in WRAPPERS.values():
            fn.launches = 0
            for variant in getattr(fn, "by_variant", {}):
                fn.by_variant[variant] = 0
