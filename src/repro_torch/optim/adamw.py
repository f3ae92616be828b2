"""AdamW state (the port's subset of ``repro/optim/adamw.py``): the
configuration and the state of zeros that a host round hands its
clients.  The update step comes with training."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

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
    stacked tree (the reference's ``jax.vmap(adamw_init)``)."""
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    shape = () if n_clients is None else (int(n_clients),)
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros(shape, dtype=torch.int32, device=device)}
