"""Local ERM, step 1 of Algorithm 1 (the port of ``repro/core/erm.py``):
closed-form ridge regression, one client or a batch of clients.
Logistic (Newton) and SGD solvers come later."""
from __future__ import annotations

import torch


def ridge_erm(x: torch.Tensor, y: torch.Tensor,
              reg: float = 1e-6) -> torch.Tensor:
    """argmin 1/2n ||X theta - y||^2 + reg/2 ||theta||^2 for x (n, d),
    y (n,) -> theta (d,)."""
    return batched_ridge_erm(x[None], y[None], reg)[0]


def batched_ridge_erm(x: torch.Tensor, y: torch.Tensor,
                      reg: float = 1e-6) -> torch.Tensor:
    """Every client's ridge ERM at once: x (w, n, d), y (w, n) ->
    (w, d), one solve over the (w, d, d) Gram stack."""
    n, d = x.shape[1], x.shape[2]
    eye = torch.eye(d, dtype=x.dtype, device=x.device)
    gram = x.mT @ x / n + reg * eye
    rhs = (x.mT @ y[..., None]) / n
    return torch.linalg.solve(gram, rhs)[..., 0]
