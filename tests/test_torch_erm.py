"""The port's logistic ERM (damped Newton, analytic gradient and Hessian)
against the JAX reference's (``jax.grad`` / ``jax.hessian``), on the CPU.

Both packages get the same numpy covariates and +-1 labels.  Newton has
no line search in either, so fp32 rounding differences are carried from
step to step: theta agrees within rtol 1e-4 and atol 1e-4 * max|theta|.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.erm import batched_logistic_erm as jbatched
from repro.core.erm import logistic_erm as jlogistic
from repro_torch.core.erm import (
    batched_logistic_erm,
    logistic_erm,
    logistic_loss,
)


def logistic_data(seed, w, n, d, scale):
    """``w`` clients of ``n`` points: y = +-1 with P(y = 1) =
    sigmoid(x . w_true + b_true); ``scale`` sets how separable they are."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(w, n, d)).astype(np.float32)
    w_true = scale * rng.normal(size=(w, d))
    b_true = rng.normal(size=(w, 1))
    z = np.einsum("wnd,wd->wn", x, w_true) + b_true
    y = np.where(rng.uniform(size=z.shape) < 1.0 / (1.0 + np.exp(-z)), 1.0,
                 -1.0).astype(np.float32)
    return x, y


def close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


CASES = [(0, 6, 64, 16, 0.5, 1e-5, 25), (1, 6, 64, 16, 4.0, 1e-6, 8),
         (2, 3, 200, 4, 1.0, 1e-3, 25), (3, 5, 16, 8, 0.3, 1e-2, 10)]


@pytest.mark.parametrize("seed,w,n,d,scale,reg,iters", CASES)
def test_batched_logistic_erm_matches_reference(seed, w, n, d, scale, reg,
                                                iters):
    x, y = logistic_data(seed, w, n, d, scale)
    want = jbatched(jnp.asarray(x), jnp.asarray(y), reg, iters)
    got = batched_logistic_erm(torch.from_numpy(x), torch.from_numpy(y),
                               reg, iters)
    assert got.shape == (w, d + 1) and got.dtype == torch.float32
    close(got.numpy(), want)


@pytest.mark.parametrize("seed,w,n,d,scale,reg,iters", CASES)
def test_logistic_erm_matches_reference(seed, w, n, d, scale, reg, iters):
    x, y = logistic_data(seed, w, n, d, scale)
    want = jlogistic(jnp.asarray(x[0]), jnp.asarray(y[0]), reg, iters)
    got = logistic_erm(torch.from_numpy(x[0]), torch.from_numpy(y[0]), reg,
                       iters)
    close(got.numpy(), want)


@pytest.mark.parametrize("seed,reg", [(4, 1e-5), (5, 1e-2)])
def test_newton_reaches_the_stationary_point(seed, reg):
    """On non-separable data 25 steps reach the optimum: the autograd
    gradient of the loss vanishes there, and the loss matches the
    reference's objective at the reference's solution."""
    x, y = logistic_data(seed, 4, 256, 6, 0.5)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    theta = batched_logistic_erm(xt, yt, reg, 25).requires_grad_(True)
    loss = logistic_loss(theta, xt, yt, reg)
    (grad,) = torch.autograd.grad(loss.sum(), theta)
    assert float(grad.abs().max()) < 1e-5
    want = np.asarray(jbatched(jnp.asarray(x), jnp.asarray(y), reg, 25))
    ref_loss = logistic_loss(torch.from_numpy(want), xt, yt, reg)
    np.testing.assert_allclose(loss.detach().numpy(), ref_loss.numpy(),
                               rtol=1e-6)
