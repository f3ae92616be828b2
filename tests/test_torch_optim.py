"""The port's optimizers and schedules against the JAX reference.

AdamW: the same parameters, gradients and state (numpy, from a seed)
through ``repro.optim.adamw_update`` and the port's ``adamw_update`` /
``adamw_update_``, in fp32 and in bf16 parameters (fp32 moments), with
weight decay (applied only to leaves of two or more dimensions) and the
gradient clip active.  Tolerance: rtol 1e-5 / atol 1e-7 on fp32 values
(the same fp32 operations, XLA's order of evaluation); bf16 parameters
equal or one bf16 ulp apart.  On a stacked tree the step is per client,
against ``jax.vmap(adamw_update)``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import cosine_schedule as jcosine
from repro.optim import linear_warmup as jwarmup
from repro.optim import sgd_init as jsgd_init
from repro.optim import sgd_update as jsgd_update
from repro_torch import runtime
from repro_torch.interop import params_from_numpy
from repro_torch.launch.steps import client_slice
from repro_torch.optim import (
    AdamWConfig,
    adamw_init,
    adamw_reset_,
    adamw_update,
    adamw_update_,
    cosine_schedule,
    linear_warmup,
    sgd_init,
    sgd_update,
)
from repro_torch.optim.adamw import _global_norm
from repro_torch.utils import tree_leaves, tree_map

RTOL, ATOL = 1e-5, 1e-7


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One host thread: the tensors here are small, and parallel test
    workers must not oversubscribe the CPU."""
    with runtime.pinned_threads(1):
        yield


def tree(rng, lead=()):
    return {"w": rng.normal(size=lead + (6, 5)).astype(np.float32),
            "b": rng.normal(size=lead + (5,)).astype(np.float32),
            "blk": {"k": rng.normal(size=lead + (2, 3, 4)).astype(np.float32)}}


def jtree(t, dtype=jnp.float32):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), t)


def ttree(t, dtype=torch.float32):
    return tree_map(lambda l: l.to(dtype), params_from_numpy(t, "cpu"))


def close(got, want, rtol=RTOL, atol=ATOL):
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32),
                                   rtol=rtol, atol=atol)


CFGS = [dict(), dict(weight_decay=0.0), dict(grad_clip=None),
        dict(grad_clip=0.1, weight_decay=0.3, lr=1e-2)]


@pytest.mark.parametrize("opts", CFGS, ids=lambda o: str(o) or "default")
def test_adamw_matches_reference_over_steps(opts):
    rng = np.random.default_rng(0)
    p, grads = tree(rng), [tree(rng) for _ in range(4)]
    jp, js = jtree(p), jadamw_init(jtree(p))
    tp = ttree(p)
    ts = adamw_init(tp)
    for g in grads:
        jp, js = jadamw_update(jp, jtree(g), js, JAdamWConfig(**opts))
        tp, ts = adamw_update(tp, ttree(g), ts, AdamWConfig(**opts))
    close(tp, jp)
    close(ts["mu"], js["mu"])
    close(ts["nu"], js["nu"], atol=1e-9)
    assert int(ts["step"]) == int(js["step"]) == 4


def test_adamw_bf16_params_fp32_moments():
    rng = np.random.default_rng(1)
    p, g = tree(rng), tree(rng)
    jp, js = jadamw_update(jtree(p, jnp.bfloat16), jtree(g, jnp.bfloat16),
                           jadamw_init(jtree(p, jnp.bfloat16)),
                           JAdamWConfig(lr=1e-2))
    tp0 = ttree(p, torch.bfloat16)
    tp, ts = adamw_update(tp0, ttree(g, torch.bfloat16), adamw_init(tp0),
                          AdamWConfig(lr=1e-2))
    for leaf in tree_leaves(tp):
        assert leaf.dtype == torch.bfloat16
    for leaf in tree_leaves(ts["mu"]) + tree_leaves(ts["nu"]):
        assert leaf.dtype == torch.float32
    # one bf16 ulp (2^-8 relative) at most
    close(tp, jp, rtol=2.0 ** -8, atol=0)
    close(ts["mu"], js["mu"])


def test_weight_decay_skips_vectors():
    p = {"w": np.ones((3, 3), np.float32), "b": np.ones((3,), np.float32)}
    z = {k: np.zeros_like(v) for k, v in p.items()}
    tp, _ = adamw_update(ttree(p), ttree(z), adamw_init(ttree(p)),
                         AdamWConfig(lr=0.1, weight_decay=0.5))
    assert torch.allclose(tp["w"], torch.full((3, 3), 0.95))
    assert torch.equal(tp["b"], torch.ones(3))


def test_in_place_update_equals_pure_update_and_leaves_inputs():
    rng = np.random.default_rng(2)
    p, g = ttree(tree(rng)), ttree(tree(rng))
    before = {k: v.clone() for k, v in tree_leaves_dict(p).items()}
    state = adamw_init(p)
    new_p, new_s = adamw_update(p, g, state, AdamWConfig())
    for k, v in tree_leaves_dict(p).items():
        assert torch.equal(v, before[k])
    assert int(state["step"]) == 0
    adamw_update_(p, g, state, AdamWConfig())
    for a, b in zip(tree_leaves(p), tree_leaves(new_p)):
        assert torch.equal(a, b)
    assert int(state["step"]) == 1
    adamw_reset_(state)
    assert all(float(t.abs().sum()) == 0 for t in tree_leaves(state))


def tree_leaves_dict(t, prefix=""):
    out = {}
    for k, v in t.items():
        if isinstance(v, dict):
            out.update(tree_leaves_dict(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def test_stacked_step_is_per_client_like_vmap():
    """Client c's update on views of the stacked tree (how the local
    step runs) equals ``jax.vmap(adamw_update)``: per-client clip, norm
    and step count."""
    rng = np.random.default_rng(3)
    c = 3
    p, g = tree(rng, (c,)), tree(rng, (c,))
    g["w"][1] *= 100.0                       # only client 1 is clipped
    cfg = JAdamWConfig(grad_clip=1.0, weight_decay=0.1)
    jp, js = jax.vmap(lambda a, b, s: jadamw_update(a, b, s, cfg))(
        jtree(p), jtree(g), jax.vmap(jadamw_init)(jtree(p)))
    tp, tg = ttree(p), ttree(g)
    ts = adamw_init(tp, c)
    for i in range(c):
        adamw_update_(client_slice(tp, i), client_slice(tg, i),
                      client_slice(ts, i), AdamWConfig(**vars(cfg)))
    close(tp, jp)
    close(ts["mu"], js["mu"])
    assert ts["step"].tolist() == [1, 1, 1]
    assert float(_global_norm(client_slice(tg, 1))) > 100.0


@pytest.mark.parametrize("momentum,radius", [(0.0, None), (0.9, None),
                                             (0.5, 2.0)])
def test_sgd_matches_reference(momentum, radius):
    rng = np.random.default_rng(4)
    p = tree(rng)
    jp, js = jtree(p), jsgd_init(jtree(p), momentum)
    tp, ts = ttree(p), sgd_init(ttree(p), momentum)
    for _ in range(3):
        g = tree(rng)
        jp, js = jsgd_update(jp, jtree(g), js, lr=0.1, momentum=momentum,
                             radius=radius)
        tp, ts = sgd_update(tp, ttree(g), ts, lr=0.1, momentum=momentum,
                            radius=radius)
    close(tp, jp)
    assert int(ts["step"]) == int(js["step"]) == 3
    if momentum:
        close(ts["vel"], js["vel"])


@pytest.mark.parametrize("warmup,total", [(0, 100), (10, 100), (50, 60)])
def test_schedules_match_reference(warmup, total):
    steps = np.arange(0, 120, 7, dtype=np.float32)
    np.testing.assert_allclose(
        linear_warmup(torch.from_numpy(steps), warmup).numpy(),
        np.asarray(jwarmup(jnp.asarray(steps), warmup)), rtol=1e-6)
    np.testing.assert_allclose(
        cosine_schedule(torch.from_numpy(steps), total, warmup).numpy(),
        np.asarray(jcosine(jnp.asarray(steps), total, warmup)), rtol=1e-6,
        atol=1e-7)
    assert abs(float(cosine_schedule(5, total, warmup))
               - float(jcosine(5, total, warmup))) < 1e-6
