"""The port's logistic ERM (damped Newton, analytic gradient and Hessian)
against the JAX reference's (``jax.grad`` / ``jax.hessian``), on the CPU.

Both packages get the same numpy covariates and +-1 labels.  Newton has
no line search in either, so fp32 rounding differences are carried from
step to step: theta agrees within rtol 1e-4 and atol 1e-4 * max|theta|.

The projected SGD of Appendix D (``sgd_erm``) gets the reference's
minibatch rows (its ``split`` / ``randint`` chain replayed with jax) and
agrees within 1e-5 of the largest magnitude; on the port's own draws it
passes the reference's Appendix D check (``tests/test_substrates.py``).
The tree helpers equal the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.erm import batched_logistic_erm as jbatched
from repro.core.erm import logistic_erm as jlogistic
from repro.core.erm import ridge_erm as jridge
from repro.core.erm import sgd_erm as jsgd
from repro.utils import tree as jtree
from repro_torch import runtime
from repro_torch import utils as tutils
from repro_torch.core.erm import (
    batched_logistic_erm,
    logistic_erm,
    logistic_loss,
    ridge_erm,
    sgd_erm,
)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One host thread: the tensors here are small, and parallel test
    workers must not oversubscribe the CPU."""
    with runtime.pinned_threads(1):
        yield


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


def sgd_data(seed, n=500, d=4):
    """Appendix D's problem: noisy linear samples, the squared loss."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=d).astype(np.float32)
    y = (x @ w + 0.01 * rng.normal(size=n)).astype(np.float32)
    return x, y


def reference_rows(key, steps, batch, n):
    """The reference's minibatch rows: at each step ``key, sub =
    split(key)`` then ``randint(sub, (batch,), 0, n)``."""
    def body(key, _):
        key, sub = jax.random.split(key)
        return key, jax.random.randint(sub, (batch,), 0, n)

    return np.asarray(jax.lax.scan(body, key, None, length=steps)[1])


def j_tree_loss(theta, b):
    r = b[0] @ theta["w"] + theta["b"] - b[1]
    return 0.5 * jnp.mean(r * r)


def t_tree_loss(theta, b):
    r = b[0] @ theta["w"] + theta["b"] - b[1]
    return 0.5 * torch.mean(r * r)


def j_vec_loss(theta, b):
    r = b[0] @ theta - b[1]
    return 0.5 * jnp.mean(r * r)


def t_vec_loss(theta, b):
    r = b[0] @ theta - b[1]
    return 0.5 * torch.mean(r * r)


@pytest.mark.parametrize("seed,steps,batch,mu,radius,tree", [
    (2, 400, 32, 1.0, 100.0, False), (3, 300, 8, 2.0, None, False),
    (4, 200, 16, 1.0, 1.0, True), (5, 250, 8, 0.5, None, True)])
def test_sgd_erm_matches_reference_on_its_rows(seed, steps, batch, mu,
                                               radius, tree):
    x, y = sgd_data(seed)
    key = jax.random.PRNGKey(seed)
    if tree:
        j0 = {"w": jnp.zeros(4), "b": jnp.zeros(())}
        t0 = {"w": torch.zeros(4), "b": torch.zeros(())}
        jloss, tloss = j_tree_loss, t_tree_loss
    else:
        j0, t0, jloss, tloss = jnp.zeros(4), torch.zeros(4), j_vec_loss, \
            t_vec_loss
    want = jsgd(key, j0, (jnp.asarray(x), jnp.asarray(y)), jloss,
                steps=steps, batch=batch, mu=mu, radius=radius)
    got = sgd_erm(None, t0, (torch.from_numpy(x), torch.from_numpy(y)),
                  tloss, steps=steps, batch=batch, mu=mu, radius=radius,
                  indices=reference_rows(key, steps, batch, len(x)))
    want_v = np.concatenate([np.ravel(l) for l in jax.tree_util.tree_leaves(
        want)])
    got_v = tutils.tree_to_vector(got).numpy()
    scale = float(np.abs(want_v).max())
    assert np.abs(got_v - want_v).max() <= 1e-5 * scale
    if radius is not None:
        assert np.linalg.norm(got_v) <= radius * (1 + 1e-6)


def test_sgd_erm_appendix_d_on_the_ports_own_draws():
    """``tests/test_substrates.py``'s check: 2000 steps of batch 32 land
    within 0.3 of the exact ridge solution."""
    x, y = sgd_data(2)
    data = (torch.from_numpy(x), torch.from_numpy(y))
    exact = ridge_erm(*data, 1e-6)
    np.testing.assert_allclose(exact.numpy(), np.asarray(jridge(
        jnp.asarray(x), jnp.asarray(y), 1e-6)), rtol=1e-4, atol=1e-5)
    approx = sgd_erm(torch.Generator().manual_seed(0), torch.zeros(4), data,
                     t_vec_loss, steps=2000, batch=32, mu=1.0, radius=100.0)
    assert float(torch.linalg.vector_norm(approx - exact)) < 0.3


def test_sgd_erm_refuses_rows_of_another_shape():
    x, y = sgd_data(2, n=20)
    with pytest.raises(ValueError, match="steps, batch"):
        sgd_erm(None, torch.zeros(4), (torch.from_numpy(x),
                                       torch.from_numpy(y)), t_vec_loss,
                steps=5, batch=4, indices=np.zeros((5, 3), np.int64))


def test_tree_helpers_match_the_reference():
    rng = np.random.default_rng(7)
    tree = {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": {"c": rng.normal(size=(3,)).astype(np.float32),
                  "n": np.arange(6, dtype=np.int32).reshape(3, 2)}}
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    tt = tutils.tree_map(torch.from_numpy, tree)

    def same(got, want, **tol):
        got_l, want_l = tutils.tree_leaves(got), jax.tree_util.tree_leaves(
            want)
        assert len(got_l) == len(want_l)
        for g, w in zip(got_l, want_l):
            assert str(g.dtype).split(".")[-1] == str(w.dtype)
            np.testing.assert_allclose(
                g.to(torch.float64 if g.is_floating_point() else g.dtype)
                .numpy(), np.asarray(w).astype(
                    np.float64 if g.is_floating_point() else w.dtype), **tol)

    floats = {"a": tree["a"], "c": tree["b"]["c"]}
    jf = jax.tree_util.tree_map(jnp.asarray, floats)
    tf = tutils.tree_map(torch.from_numpy, floats)
    same(tutils.tree_axis_mean(tf), jtree.tree_axis_mean(jf), rtol=1e-6)
    same(tutils.tree_axis_mean(tf, axis=-1)["a"],
         jtree.tree_axis_mean(jf, axis=-1)["a"], rtol=1e-6)
    same(tutils.tree_select(tt, 1), jtree.tree_select(jt, 1))
    same(tutils.tree_cast(tt, torch.bfloat16), jtree.tree_cast(
        jt, jnp.bfloat16))
    assert tutils.tree_cast(tt, torch.bfloat16)["b"]["n"].dtype == \
        torch.int32
    got = tutils.tree_l2_norm(tutils.tree_cast(tf, torch.bfloat16))
    want = jtree.tree_l2_norm(jtree.tree_cast(jf, jnp.bfloat16))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert float(tutils.tree_l2_norm({})) == 0.0
