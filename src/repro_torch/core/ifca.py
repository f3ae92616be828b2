"""IFCA baseline [Ghosh et al., 2022], the paper's main comparison (the
port of ``repro/core/ifca.py``).

Iterative Federated Clustering Algorithm (Appendix C description):

  repeat T rounds:
    1. server broadcasts K models {theta_k^t}
    2. each user picks the model with the smallest local loss
    3. gradient averaging: users send grad f_i(theta_(i)) and the server
       does theta_k <- theta_k - alpha * mean_{i in C_k^t} g_i
       (or model averaging: tau local steps then cluster-average)

Needs knowledge of K and, per the paper's experiments, succeeds only with
sufficiently close initialization (IFCA-1/IFCA-2/IFCA-R variants).

``loss_fn(theta, x, y)`` and ``grad_fn(theta, x, y)`` are per-user torch
functions (``torch.func.grad(loss_fn)`` is one such ``grad_fn``),
vectorized over users and models by ``torch.func.vmap``.  The losses are
plain tensor ops, as the reference's are, not a kernel; the reference's
``lax.scan`` over rounds is a loop that stacks the (T, K, d) history.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class IFCAConfig:
    k: int
    rounds: int = 200
    step_size: float = 0.1
    mode: str = "gradient"         # 'gradient' | 'model'
    local_steps: int = 5           # for mode='model'


def ifca_init_near_optima(generator: torch.Generator, optima,
                          noise_std: float) -> torch.Tensor:
    """IFCA-1/IFCA-2 init: true optima + N(0, std^2) noise (Section 5), on
    the generator's device."""
    optima = torch.as_tensor(optima, dtype=torch.float32).to(
        generator.device)
    return optima + noise_std * torch.randn(
        optima.shape, generator=generator, device=generator.device)


def ifca_init_annulus(generator: torch.Generator, optima, d_min: float,
                      lo_frac: float = 0.2,
                      hi_frac: float = 1.0 / 3.0) -> torch.Tensor:
    """Appendix E.4 init: a random point at distance in [D/5, D/3] from
    each optimum, on the generator's device."""
    optima = torch.as_tensor(optima, dtype=torch.float32).to(
        generator.device)
    k, d = optima.shape
    dirs = torch.randn((k, d), generator=generator, device=generator.device)
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=1, keepdim=True)
    u = torch.rand((k, 1), generator=generator, device=generator.device)
    radii = lo_frac * d_min + (hi_frac - lo_frac) * d_min * u
    return optima + dirs * radii


def per_user_model_losses(theta, xs, ys, loss_fn: Callable) -> torch.Tensor:
    """(m, K) local loss of every broadcast model at every user: the
    cluster-estimate rule of step 2 (argmin over the K columns)."""
    per_model = torch.func.vmap(loss_fn, in_dims=(0, None, None))
    return torch.func.vmap(per_model, in_dims=(None, 0, 0))(theta, xs, ys)


def _assign(theta, xs, ys, loss_fn) -> torch.Tensor:
    """Each user's lowest-loss model (ties to the lowest index)."""
    return torch.argmin(per_user_model_losses(theta, xs, ys, loss_fn), dim=1)


def ifca(theta0, xs, ys, loss_fn: Callable, grad_fn: Callable,
         cfg: IFCAConfig):
    """Run IFCA on the device of ``theta0``.

    theta0: (K, d) initial models.  xs: (m, n, ...), ys: (m, n).
    Returns (theta_T (K, d), labels (m,), history (T, K, d))."""
    theta = torch.as_tensor(theta0, dtype=torch.float32)
    xs = torch.as_tensor(xs).to(theta.device)
    ys = torch.as_tensor(ys).to(theta.device)
    grads_of = torch.func.vmap(grad_fn)
    history = []
    for _ in range(cfg.rounds):
        assign = _assign(theta, xs, ys, loss_fn)
        onehot = torch.nn.functional.one_hot(assign, cfg.k).to(torch.float32)
        size = torch.sum(onehot, dim=0)
        cnt = torch.clamp_min(size, 1.0)[:, None]
        if cfg.mode == "gradient":
            grads = grads_of(theta[assign], xs, ys)          # (m, d)
            theta = theta - cfg.step_size * (onehot.T @ grads) / cnt
        else:  # model averaging with tau local GD steps
            local = theta[assign]
            for _ in range(cfg.local_steps):
                local = local - cfg.step_size * grads_of(local, xs, ys)
            avg = (onehot.T @ local) / cnt
            theta = torch.where((size > 0)[:, None], avg, theta)
        history.append(theta)
    history = (torch.stack(history) if history else
               theta.new_zeros((0,) + tuple(theta.shape)))
    return theta, _assign(theta, xs, ys, loss_fn), history
