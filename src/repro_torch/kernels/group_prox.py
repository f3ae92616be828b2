"""Row-wise L2-ball projection (the AMA dual prox) and the AMA
iteration's two passes over the dual: the CUDA kernels' wrappers and
their plain PyTorch versions.

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

One AMA iteration (``core/engine/device_convex.py``) is two launches:
``ama_gather_back`` (u = a + head sums - tail sums of the dual, a
segment kernel that adds each run in order) and
``group_ball_proj_batched`` given the step's operands as keywords
(``step_operands``; the prox's fused instance: the edge
difference and the gradient step before the projection, max |new - nu|
after it; counted as the ``ama_step`` variant, the plain projection as
``plain``).  ``ama_step_ref`` and ``ama_gather_back_ref`` are their
plain versions, the PyTorch composition the loop ran before.
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


def ama_step_ref(nu: torch.Tensor, radius, *, u, i_idx, j_idx, eta,
                 moved) -> torch.Tensor:
    """One AMA edge pass in plain PyTorch, in place: nu (b,e,d) becomes
    the prox of nu - eta * (u[:, i_idx] - u[:, j_idx]) (u (b,m,d)) and
    ``moved`` (a 0-d fp32 tensor) max |new - nu|.  Returns nu."""
    grad = u[:, i_idx] - u[:, j_idx]
    new = group_ball_proj_batched_ref(nu - eta * grad, radius)
    moved.copy_(torch.max(torch.abs(new - nu)))
    return nu.copy_(new)


def ama_gather_back_ref(a: torch.Tensor, nu: torch.Tensor, heads, tails,
                        u: torch.Tensor) -> torch.Tensor:
    """u (b,m,d) = a (m,d) + (segment sums of nu (b,e,d) over the heads'
    ``SegmentPlan`` - over the tails'), in plain PyTorch, written into
    ``u``.  Returns u."""
    # the engine's segment sums; imported here, since the engine's
    # package imports the kernels
    from repro_torch.core.engine.segment import segment_sum

    return u.copy_(a[None] + (segment_sum(nu, heads, axis=1)
                              - segment_sum(nu, tails, axis=1)))


def _radius_view(radius, shape, device) -> torch.Tensor:
    """The radius as an fp32 CUDA tensor broadcast (by strides, not by a
    copy) to ``shape``."""
    r = torch.as_tensor(radius, dtype=torch.float32, device=device)
    if r.device != device:
        raise ValueError(f"radius lies on {r.device}, v on {device}")
    return torch.broadcast_to(r, shape)


def _launch(wrapper, v: torch.Tensor, radius, batched: bool,
            step: dict | None = None) -> torch.Tensor:
    """Check, allocate and launch; counts the launch on ``wrapper`` (the
    batched one by variant).  ``step``: the fused AMA step's operands."""
    name = wrapper.__name__
    _check_operands(name, v, ndim=3 if batched else 2)
    b, e, d = v.shape if batched else (1, *v.shape)
    if step is None:
        out = torch.empty_like(v)
    else:
        _check_step(name, v, step)
        out = v
    r = _radius_view(radius, v.shape[:-1], v.device)
    if b == 0 or e == 0 or d == 0:
        if step is not None:
            step["moved"].zero_()
        return out
    if d >= 2 ** 31:
        raise ValueError(f"{name}: rows of {d} values exceed the kernel's "
                         "32-bit width")
    with torch.cuda.device(v.device):
        lib = _build.load("group_prox")
        stream = torch.cuda.current_stream().cuda_stream
        if step is not None:
            u = step["u"]
            err = lib.ama_step_f32(
                v.data_ptr(), r.data_ptr(), b, e, d,
                r.stride(0), r.stride(1), u.data_ptr(), u.shape[1],
                step["i_idx"].data_ptr(), step["j_idx"].data_ptr(),
                step["eta"].data_ptr(), step["moved"].data_ptr(), stream)
        elif batched:
            err = lib.group_ball_proj_batched_f32(
                v.data_ptr(), r.data_ptr(), out.data_ptr(), b, e, d,
                r.stride(0), r.stride(1), stream)
        else:
            err = lib.group_ball_proj_f32(v.data_ptr(), r.data_ptr(),
                                          out.data_ptr(), e, d, r.stride(0),
                                          stream)
    _build.check(err, f"{name} launch at {tuple(v.shape)}")
    if batched:
        count_launch(wrapper, "plain" if step is None else "ama_step")
    else:
        count_launch(wrapper)
    return out


def _check_step(name: str, nu: torch.Tensor, step: dict) -> None:
    """Check the fused step's operands."""
    u = step["u"]
    _check_operands(name, u, nu, ndim=3)
    for key in ("eta", "moved"):
        if (step[key].device != nu.device or step[key].numel() != 1
                or step[key].dtype != torch.float32):
            raise ValueError(f"{name}: {key} must be one float32 on "
                             f"{nu.device}")
    b, e, d = nu.shape
    if u.shape[0] != b or u.shape[2] != d:
        raise ValueError(f"{name}: u {tuple(u.shape)} does not fit nu "
                         f"{tuple(nu.shape)}")
    m = u.shape[1]
    for key in ("i_idx", "j_idx"):
        idx = step[key]
        if (idx.device != nu.device or idx.dtype != torch.int32
                or idx.shape != (e,) or not idx.is_contiguous()):
            raise ValueError(f"{name}: {key} must be ({e},) contiguous int32 "
                             f"on {nu.device}")
    if m >= 2 ** 31:
        raise ValueError(f"{name}: {m} nodes exceed the int32 edge ends")


def group_ball_proj(v: torch.Tensor, radius) -> torch.Tensor:
    """Launch the CUDA kernel: v (e,d) fp32 CUDA tensor, radius a scalar
    or (e,) -> (e,d) fp32, on the current stream.  e = 0 returns the empty
    result without a launch."""
    return _launch(group_ball_proj, v, radius, batched=False)


def group_ball_proj_batched(v: torch.Tensor, radius, *, u=None, i_idx=None,
                            j_idx=None, eta=None,
                            moved=None) -> torch.Tensor:
    """Launch the CUDA kernel: v (b,e,d) fp32 CUDA tensor, radius
    broadcastable to (b,e) -> (b,e,d) fp32, on the current stream.  e = 0
    returns the empty (b,0,d) result without a launch.

    With the AMA step's operands (all of them) v is the dual nu, and the
    launch is the fused edge pass of ``ama_step_ref``, which steps nu in
    place and returns it: u (b,m,d), the edge ends ``i_idx``, ``j_idx``
    ((e,) int32), ``eta`` and ``moved`` (one fp32 each, on the card)."""
    step = step_operands(u=u, i_idx=i_idx, j_idx=j_idx, eta=eta, moved=moved)
    return _launch(group_ball_proj_batched, v, radius, batched=True,
                   step=step)


def step_operands(**operands) -> dict | None:
    """The AMA step's operands as given to ``group_ball_proj_batched``, or
    None where none is given; some but not all of them is an error."""
    given = [k for k, val in operands.items() if val is not None]
    if not given:
        return None
    if len(given) != len(operands):
        missing = sorted(set(operands) - set(given))
        raise ValueError(f"the AMA step needs all of its operands; missing "
                         f"{missing}")
    return operands


def ama_gather_back(a: torch.Tensor, nu: torch.Tensor, heads, tails,
                    u: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: u (b,m,d) = a (m,d) + (sums of nu (b,e,d)
    over each node's heads - over its tails), written into ``u``, fp32
    CUDA tensors, the heads and tails as ``SegmentPlan``s of m segments
    (int64 ``starts``, int32 ``order`` or None), on the current stream;
    returns u.  Each run is added in order, as the plain version adds it:
    the same inputs give the same bits, and the plain version's."""
    name = "ama_gather_back"
    _check_operands(name, a, ndim=2)
    _check_operands(name, nu, u, ndim=3)
    m, d = a.shape
    b, e = nu.shape[:2]
    if nu.shape[2] != d or nu.device != a.device:
        raise ValueError(f"{name}: nu {tuple(nu.shape)} does not fit a "
                         f"{tuple(a.shape)}")
    if u.shape != (b, m, d):
        raise ValueError(f"{name}: u {tuple(u.shape)} is not "
                         f"{(b, m, d)}")
    for plan in (heads, tails):
        if (plan.starts.shape != (m + 1,) or plan.starts.dtype != torch.int64
                or plan.starts.device != a.device):
            raise ValueError(f"{name}: a plan's starts must be ({m + 1},) "
                             f"int64 on {a.device}")
        if plan.order is not None and (
                plan.order.shape != (e,) or plan.order.dtype != torch.int32
                or plan.order.device != a.device):
            raise ValueError(f"{name}: a plan's order must be ({e},) int32 "
                             f"on {a.device}")
    if b == 0 or m == 0 or d == 0:
        return u
    with torch.cuda.device(a.device):
        lib = _build.load("group_prox")
        err = lib.ama_gather_back_f32(
            a.data_ptr(), nu.data_ptr(), heads.starts.data_ptr(),
            _ptr(heads.order), tails.starts.data_ptr(), _ptr(tails.order),
            u.data_ptr(), b, m, e, d, torch.cuda.current_stream().cuda_stream)
    _build.check(err, f"{name} launch at {tuple(nu.shape)}")
    count_launch(ama_gather_back)
    return u


def _ptr(t):
    return None if t is None else t.data_ptr()


group_ball_proj.launches = 0
group_ball_proj_batched.launches = 0
group_ball_proj_batched.by_variant = {"plain": 0, "ama_step": 0}
ama_gather_back.launches = 0
