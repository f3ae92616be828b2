"""(Projected) SGD with optional momentum, the Appendix-D local solver
(the port of ``repro/optim/sgd.py``)."""
from __future__ import annotations

import torch

from repro_torch.utils import tree_leaves, tree_map


def sgd_init(params, momentum: float = 0.0) -> dict:
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    if momentum == 0.0:
        return {"step": step}
    return {"vel": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params),
            "step": step}


@torch.no_grad()
def sgd_update(params, grads, state: dict, *, lr: float,
               momentum: float = 0.0, radius: float | None = None):
    """One SGD step; optional projection onto ||theta|| <= radius
    (Assumption 2's compact parameter space).  Returns (new_params,
    new_state)."""
    step = state["step"] + 1
    if momentum > 0.0:
        vel = tree_map(lambda v, g: momentum * v + g.float(), state["vel"],
                       grads)
        upd_tree, new_state = vel, {"vel": vel, "step": step}
    else:
        upd_tree, new_state = grads, {"step": step}
    new_p = tree_map(lambda p, u: (p.float() - lr * u.float()).to(p.dtype),
                     params, upd_tree)
    if radius is not None:
        norm = torch.sqrt(sum(torch.sum(torch.square(l.float()))
                              for l in tree_leaves(new_p)))
        scale = torch.clamp(radius / torch.clamp_min(norm, 1e-30), max=1.0)
        new_p = tree_map(lambda p: (p * scale).to(p.dtype), new_p)
    return new_p, new_state
