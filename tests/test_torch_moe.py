"""The port's MoE layer (``repro_torch/models/moe.py``) against the
reference's, on the same numpy weights and inputs (fp32): the reduced
deepseek-moe-16b (8 experts, top 6, two shared experts) and grok-1-314b
(4 experts, top 2, none shared), at the configured capacity factor and
at 0.25, where experts drop tokens.  Outputs within 1e-5 of their
largest magnitude, the aux loss within 1e-6 relative.

A token whose k-th and (k+1)-th router probabilities lie within rounding
of each other may pick another expert in the other framework (their
softmaxes round differently), and attention would then carry the change
to every later token of the sequence.  So every parity input here first
asserts that its smallest top-k margin is above 1e-4.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import moe as jmoe
from repro_torch import runtime
from repro_torch.configs import get_config as tget_config
from repro_torch.models import moe as tmoe

MARGIN = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One host thread: the tensors here are small, and parallel test
    workers must not oversubscribe the CPU."""
    with runtime.pinned_threads(1):
        yield


def _cfgs(arch, capacity_factor=None):
    kw = {"max_experts": 8} if arch == "deepseek-moe-16b" else {}
    cfg, tcfg = jget_config(arch).reduced(**kw), tget_config(arch).reduced(**kw)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
        tcfg = dataclasses.replace(tcfg, capacity_factor=capacity_factor)
    return cfg, tcfg


def _namespace(tree):
    return SimpleNamespace(**{
        k: _namespace(v) if isinstance(v, dict) else torch.from_numpy(
            np.array(v)) for k, v in tree.items()})


def _weights(cfg, seed=0):
    params = jmoe.init_moe(jax.random.PRNGKey(seed), cfg, jnp.float32)
    return params, _namespace(jax.tree_util.tree_map(np.asarray, params))


def _topk_margin(x, router, k):
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1)
    top = np.sort(np.asarray(probs), axis=-1)[..., ::-1]
    return float((top[..., k - 1] - top[..., k]).min())


def _reference_drops(x, router, cfg) -> int:
    """(token, choice) pairs the reference's dispatch drops: the k choices
    of each token, stably sorted by expert id, past an expert's cap."""
    _, topi = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x) @ router, -1),
                            cfg.top_k)
    b, s, _ = x.shape
    cap = jmoe._round_up(max(1, int(s * cfg.top_k / cfg.n_experts
                                    * cfg.capacity_factor)), 8)
    eid = np.asarray(topi).reshape(b, -1)
    sorted_eid = np.sort(eid, axis=1, kind="stable")
    dropped = 0
    for row in sorted_eid:
        _, counts = np.unique(row, return_counts=True)
        dropped += int(np.clip(counts - cap, 0, None).sum())
    return dropped


@pytest.mark.parametrize("capacity_factor", [None, 0.25],
                         ids=["configured", "drops"])
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "grok-1-314b"])
def test_moe_forward_matches(arch, capacity_factor):
    cfg, tcfg = _cfgs(arch, capacity_factor)
    jparams, tparams = _weights(cfg)
    x = np.random.default_rng(1).normal(
        size=(2, 32, cfg.d_model)).astype(np.float32)
    assert _topk_margin(x, jparams["router"], cfg.top_k) > MARGIN
    drops = _reference_drops(x, jparams["router"], cfg)
    assert (drops > 0) == (capacity_factor is not None)
    jy, jaux = jmoe.moe_forward(jparams, jnp.asarray(x), cfg)
    ty, taux = tmoe.moe_forward(tparams, torch.from_numpy(x), tcfg)
    want = np.asarray(jy)
    err = float(np.abs(ty.numpy() - want).max())
    assert err <= 1e-5 * float(np.abs(want).max()), err
    assert taux.dtype == torch.float32 and taux.ndim == 0
    assert float(taux) == pytest.approx(float(jaux), rel=1e-6)


def test_shared_experts_are_the_dense_path():
    """With every routed expert's output weight zeroed, the layer is the
    shared experts' SwiGLU alone (deepseek), and 0 without them (grok)."""
    for arch in ("deepseek-moe-16b", "grok-1-314b"):
        cfg, tcfg = _cfgs(arch)
        _, tparams = _weights(cfg, seed=2)
        tparams.w_out.zero_()
        x = torch.from_numpy(np.random.default_rng(2).normal(
            size=(1, 8, cfg.d_model)).astype(np.float32))
        y, _ = tmoe.moe_forward(tparams, x, tcfg)
        if cfg.n_shared_experts:
            h = x @ tparams.shared.w_in
            gate, up = torch.chunk(h, 2, dim=-1)
            want = (torch.nn.functional.silu(gate) * up) @ tparams.shared.w_out
            torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-6)
        else:
            assert torch.equal(y, torch.zeros_like(y))


def test_topk_ties_go_to_the_lower_expert_id():
    """Equal probabilities: the lower expert id first, as ``lax.top_k``
    orders them (``torch.topk`` promises no order among equals)."""
    d, e, k = 4, 8, 3
    router = np.zeros((d, e), np.float32)
    router[0, [1, 5, 6]] = 1.0          # experts 1, 5, 6 tie on top
    router[1, [2, 7]] = 0.5             # then 2 and 7 tie
    x = np.zeros((1, 3, d), np.float32)
    x[0, 0, 0] = 1.0
    x[0, 1, 1] = 1.0                    # token 1: 2, 7 on top, then a 6-way tie
    _, jv, ji = (None, *jax.lax.top_k(jax.nn.softmax(
        jnp.asarray(x) @ router, -1), k))
    _, tv, ti = tmoe.route(torch.from_numpy(x), torch.from_numpy(router), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ti[0].tolist(),
                                  [[1, 5, 6], [2, 7, 0], [0, 1, 2]])
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)


@pytest.mark.parametrize("s,want", [(1, 8), (8192, 960), (4096, 480),
                                    (400, 48)])
def test_capacity_per_sequence(s, want):
    """deepseek-moe-16b: one decode token gets 8 slots an expert (never
    a drop at k = 6 of 64); a prefill of 8192 tokens 960 against a mean
    load of 768."""
    cfg = tget_config("deepseek-moe-16b")
    assert tmoe.capacity(s, cfg) == want == jmoe._round_up(
        max(1, int(s * cfg.top_k / cfg.n_experts * cfg.capacity_factor)), 8)


def test_init_moe_keeps_the_router_in_fp32():
    cfg = tget_config("deepseek-moe-16b").reduced(max_experts=8)
    params = tmoe.init_moe(torch.Generator().manual_seed(0), cfg,
                           torch.bfloat16)
    want = jmoe.init_moe(jax.random.PRNGKey(0),
                         jget_config("deepseek-moe-16b").reduced(
                             max_experts=8), jnp.bfloat16)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, leaf in flat:
        got = params
        for p in path:
            got = got[p.key]
        assert tuple(got.shape) == leaf.shape
        assert str(got.dtype).split(".")[-1] == leaf.dtype.name
