"""Local ERM, step 1 of Algorithm 1 (the port of ``repro/core/erm.py``):
closed-form ridge regression and damped-Newton logistic regression, one
client or a batch of clients in one call, and the projected SGD of
Appendix D (the inexact ERM)."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.utils import tree_leaves, tree_map


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


def logistic_loss(theta: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                  reg: float) -> torch.Tensor:
    """Mean l2-regularized logistic loss, y in {-1, +1}, theta = (w, b):
    mean log(1 + exp(-y z)) + reg/2 ||w||^2 with z = x w + b; batched
    over a leading client axis of theta (w, d+1), x and y."""
    z = (x @ theta[..., :-1, None])[..., 0] + theta[..., -1:]
    w = theta[..., :-1]
    return (torch.mean(torch.logaddexp(torch.zeros_like(z), -y * z), dim=-1)
            + 0.5 * reg * torch.sum(w * w, dim=-1))


def logistic_erm(x: torch.Tensor, y: torch.Tensor, reg: float = 1e-5,
                 iters: int = 25) -> torch.Tensor:
    """Damped-Newton solver of the logistic ERM, x (n, d), y (n,) ->
    theta (d+1,)."""
    return batched_logistic_erm(x[None], y[None], reg, iters)[0]


def batched_logistic_erm(x: torch.Tensor, y: torch.Tensor, reg: float = 1e-5,
                         iters: int = 25) -> torch.Tensor:
    """Every client's logistic ERM at once: x (w, n, d), y (w, n) ->
    (w, d+1).  ``iters`` Newton steps from zeros, with no line search as
    in the reference, each one (w, d+1, d+1) solve of the analytic
    Hessian (plus 1e-6 I) against the analytic gradient:

        g = X1^T (-y s) / n + reg [w, 0],  s = sigmoid(-y z)
        H = X1^T diag(s (1 - s)) X1 / n + reg diag(1, .., 1, 0)

    with X1 = [x, 1] (y^2 = 1)."""
    w, n, d = x.shape
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    x1 = torch.cat([x, torch.ones((w, n, 1), dtype=x.dtype,
                                  device=x.device)], dim=-1)   # (w, n, d+1)
    penal = torch.ones(d + 1, dtype=x.dtype, device=x.device)
    penal[-1] = 0.0                         # the bias is not regularized
    eye = torch.eye(d + 1, dtype=x.dtype, device=x.device)
    theta = torch.zeros((w, d + 1), dtype=x.dtype, device=x.device)
    for _ in range(iters):
        z = (x1 @ theta[..., None])[..., 0]                    # (w, n)
        s = torch.sigmoid(-y * z)
        g = (x1.mT @ (-y * s)[..., None])[..., 0] / n + reg * penal * theta
        h = ((x1.mT * (s * (1.0 - s))[:, None, :]) @ x1) / n
        h = h + torch.diag(reg * penal) + 1e-6 * eye
        theta = theta - torch.linalg.solve(h, g[..., None])[..., 0]
    return theta


def sgd_erm(generator: torch.Generator, theta0, data, loss_fn: Callable, *,
            steps: int = 200, batch: int = 8, mu: float = 1.0,
            radius: float | None = None, indices=None):
    """Projected SGD with the Appendix D step rule eta_t = 1/(mu t).

    ``loss_fn(theta, batch_data) -> scalar`` over trees; ``data`` is a
    tree whose leaves have leading axis n.  Step t (from 0) takes the
    gradient on the rows ``indices[t]`` (drawn uniformly from
    ``generator`` when not given: an int tensor of shape (steps, batch)
    carries another draw across, e.g. the reference's threefry one),
    moves by 1/(mu (t + 1)), then scales the whole tree back onto the
    ball of ``radius`` (Assumption 2's compact Theta) when given."""
    leaves = tree_leaves(data)
    n = leaves[0].shape[0]
    dev = leaves[0].device
    if indices is None:
        indices = torch.randint(0, n, (steps, batch), generator=generator,
                                device=generator.device)
    indices = torch.as_tensor(indices).to(dev, torch.long)
    if tuple(indices.shape) != (steps, batch):
        raise ValueError(f"indices of shape {tuple(indices.shape)}, not "
                         f"(steps, batch) = ({steps}, {batch})")
    grad_fn = torch.func.grad(loss_fn)
    theta = theta0
    one = torch.ones((), dtype=torch.float32, device=dev)
    for t in range(steps):
        mb = tree_map(lambda a: a[indices[t]], data)
        g = grad_fn(theta, mb)
        eta = one / (mu * (t + 1.0))
        theta = tree_map(lambda p, gg: p - eta * gg, theta, g)
        if radius is not None:
            nrm = torch.sqrt(sum(torch.sum(l * l) for l in tree_leaves(theta)))
            scale = torch.clamp(radius / torch.clamp(nrm, min=1e-30), max=1.0)
            theta = tree_map(lambda p: p * scale, theta)
    return theta
