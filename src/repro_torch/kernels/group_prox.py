"""Row-wise L2-ball projection (the AMA dual prox): the CUDA kernels'
wrappers and their plain PyTorch versions.

``group_ball_proj`` (v (e,d)) and ``group_ball_proj_batched`` (v
(b,e,d)) launch ``csrc/group_prox.cu``, the Hopper port of the TPU
kernels ``repro/kernels/group_prox.py::group_ball_proj_pallas`` and
``::group_ball_proj_batched_pallas``, and only take fp32 CUDA tensors;
``group_ball_proj_ref`` / ``group_ball_proj_batched_ref`` are the same
functions in plain PyTorch (the counterparts of
``repro/kernels/ref.py``).  Every row becomes
``v * min(1, r / ||v||)``: the norm is floored at 1e-30 and a row is
scaled only when ``||v|| > r``.  The radius may be a scalar, one per
row, or (batched) one per (b, e); the kernels read it through strides,
so a broadcast radius is never copied out to full size.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._counts import count_launch
from repro_torch.kernels.pairwise_l2 import _check_operands


def _scale(v: torch.Tensor, radius: torch.Tensor) -> torch.Tensor:
    norms = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    return torch.where(norms > radius, radius / torch.clamp_min(norms, 1e-30),
                       torch.ones_like(norms))


def group_ball_proj_ref(v: torch.Tensor, radius) -> torch.Tensor:
    """v (e,d) projected row-wise onto the L2 ball of ``radius`` (a
    scalar or (e,))."""
    v = v.float()
    r = torch.broadcast_to(torch.as_tensor(radius, dtype=torch.float32,
                                           device=v.device), (v.shape[0],))
    return v * _scale(v, r[:, None])


def group_ball_proj_batched_ref(v: torch.Tensor, radius) -> torch.Tensor:
    """v (b,e,d) projected row-wise, radius broadcast to (b,e)."""
    v = v.float()
    r = torch.broadcast_to(torch.as_tensor(radius, dtype=torch.float32,
                                           device=v.device), v.shape[:2])
    return v * _scale(v, r[..., None])


def _radius_view(radius, shape, device) -> torch.Tensor:
    """The radius as an fp32 CUDA tensor broadcast (by strides, not by a
    copy) to ``shape``."""
    r = torch.as_tensor(radius, dtype=torch.float32, device=device)
    if r.device != device:
        raise ValueError(f"radius lies on {r.device}, v on {device}")
    return torch.broadcast_to(r, shape)


def _launch(wrapper, v: torch.Tensor, radius, batched: bool) -> torch.Tensor:
    """Check, allocate and launch; counts the launch on ``wrapper``."""
    name = wrapper.__name__
    _check_operands(name, v, ndim=3 if batched else 2)
    b, e, d = v.shape if batched else (1, *v.shape)
    out = torch.empty_like(v)
    r = _radius_view(radius, v.shape[:-1], v.device)
    if b == 0 or e == 0 or d == 0:
        return out
    if d >= 2 ** 31:
        raise ValueError(f"{name}: rows of {d} values exceed the kernel's "
                         "32-bit width")
    with torch.cuda.device(v.device):
        lib = _build.load("group_prox")
        stream = torch.cuda.current_stream().cuda_stream
        if batched:
            err = lib.group_ball_proj_batched_f32(
                v.data_ptr(), r.data_ptr(), out.data_ptr(), b, e, d,
                r.stride(0), r.stride(1), stream)
        else:
            err = lib.group_ball_proj_f32(v.data_ptr(), r.data_ptr(),
                                          out.data_ptr(), e, d, r.stride(0),
                                          stream)
    _build.check(err, f"{name} launch at {tuple(v.shape)}")
    count_launch(wrapper)
    return out


def group_ball_proj(v: torch.Tensor, radius) -> torch.Tensor:
    """Launch the CUDA kernel: v (e,d) fp32 CUDA tensor, radius a scalar
    or (e,) -> (e,d) fp32, on the current stream.  e = 0 returns the empty
    result without a launch."""
    return _launch(group_ball_proj, v, radius, batched=False)


def group_ball_proj_batched(v: torch.Tensor, radius) -> torch.Tensor:
    """Launch the CUDA kernel: v (b,e,d) fp32 CUDA tensor, radius
    broadcastable to (b,e) -> (b,e,d) fp32, on the current stream.  e = 0
    returns the empty (b,0,d) result without a launch."""
    return _launch(group_ball_proj_batched, v, radius, batched=True)


group_ball_proj.launches = 0
group_ball_proj_batched.launches = 0
