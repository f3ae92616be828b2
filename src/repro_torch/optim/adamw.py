"""AdamW with decoupled weight decay (the port of
``repro/optim/adamw.py``): moments in fp32 whatever the parameters'
dtype, the update cast back to the parameter dtype, weight decay only on
leaves of two or more dimensions, the global-norm clip over the whole
tree.

``adamw_update`` is the reference's pure function; ``adamw_update_``
does the same arithmetic in place (parameters, moments and step), which
is how training runs at full width: a copy of the moments would add 8
bytes a parameter.  On a stacked federation the caller runs it once per
client on views of the client's slices, so the clip, the norm and the
step are per client, as ``jax.vmap`` gives them.  A federation whose
client axis is sharded over a mesh (``Shard(0)`` DTensors) keeps its
moments and steps sharded the same way: ``adamw_init`` builds them on
each rank's own rows, the local step updates views of the local shards
in place, and ``adamw_reset_`` zeroes the local shards, so no moment
ever leaves its rank or changes its placement.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.utils import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params, n_clients: Optional[int] = None) -> dict:
    """First and second moments of zeros in fp32 (whatever the parameters'
    dtype) and a zero step count: () for one model, (n_clients,) for a
    stacked tree (the reference's ``jax.vmap(adamw_init)``).  Moments of
    ``Shard(0)`` DTensor parameters are sharded as they are, and so is a
    stacked tree's (n_clients,) step."""
    from repro_torch.sharding.clients import tree_axis

    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None

    def zeros(p):
        # like p, so that a DTensor's moments are sharded as it is
        return torch.zeros_like(p, dtype=torch.float32,
                                memory_format=torch.contiguous_format)

    if n_clients is None:
        step = torch.zeros((), dtype=torch.int32, device=device)
    else:
        axis = tree_axis(params)
        lo, hi = axis.owned(int(n_clients))
        step = axis.place(torch.zeros((hi - lo,), dtype=torch.int32,
                                      device=device), int(n_clients))
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": step}


def adamw_reset_(state: dict) -> dict:
    """Zero a state's moments and steps in place (a fresh ``adamw_init``
    without a second allocation; a ``DTensor``'s local shard).  Returns
    it."""
    for t in tree_leaves(state):
        (t.to_local() if isinstance(t, DTensor) else t).zero_()
    return state


def _global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32, leaf by leaf in
    tree order."""
    total = None
    for l in tree_leaves(tree):
        sq = torch.sum(torch.square(l.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update_(params, grads, state: dict, cfg: AdamWConfig,
                  lr_scale: float = 1.0) -> None:
    """One AdamW step of one model, in place: ``params`` and the state's
    ``mu`` / ``nu`` / ``step`` (a 0-d int32 tensor, or a view of one
    client's entry) take their new values."""
    state["step"].add_(1)
    step = state["step"].float()
    scale = None
    if cfg.grad_clip is not None:
        gn = _global_norm(grads)
        scale = torch.clamp(cfg.grad_clip / torch.clamp_min(gn, 1e-9),
                            max=1.0)
    bc1 = 1 - torch.pow(cfg.b1, step)
    bc2 = 1 - torch.pow(cfg.b2, step)
    for p, g, mu, nu in zip(tree_leaves(params), tree_leaves(grads),
                            tree_leaves(state["mu"]),
                            tree_leaves(state["nu"])):
        g = g.float() if scale is None else g.float() * scale
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        del g
        # (mu / bc1) / (sqrt(nu / bc2) + eps) - wd p, op for op, with two
        # temporaries a leaf (a full-width leaf's fp32 copies are 0.5 GB)
        denom = nu / bc2
        denom.sqrt_().add_(cfg.eps)
        delta = (mu / bc1).div_(denom)
        del denom
        if p.ndim >= 2:
            delta.add_(cfg.weight_decay * p.float())
        # p - lr delta (a - b is a + (-b) exactly)
        p.copy_(delta.mul_(cfg.lr * lr_scale).neg_().add_(p.float()))


def adamw_update(params, grads, state: dict, cfg: AdamWConfig,
                 lr_scale: float = 1.0):
    """One AdamW step.  Returns (new_params, new_state); the inputs are
    left as they were."""
    new_params = tree_map(lambda l: l.detach().clone(), params)
    new_state = tree_map(lambda l: l.clone(), state)
    adamw_update_(new_params, grads, new_state, cfg, lr_scale)
    return new_params, new_state
