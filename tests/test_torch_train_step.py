"""The port's training forward and steps against the JAX reference, on
the reference tests' tiny config (qwen2-0.5b reduced to 1 layer, d 64,
vocab 64, fp32; 2 query heads over 1 KV head).

* ``train_attention``: the reference's direct einsum and chunked
  online-softmax paths, with its dispatch rule; ``train_loss`` and its
  gradients at seq 16 (direct) and seq 80 with ``attn_chunk`` 16
  (chunked), under every remat name: loss rtol 1e-5, gradients within
  1e-5 of their largest magnitude (fp32, other summation orders).
* ``make_local_train_step``: 4 AdamW steps on C = 4 clients from the
  reference's stacked init: losses rtol 1e-5; parameters within the
  bounds of ``assert_tree_close`` (Adam normalizes rounding noise in
  near-zero gradients up to lr-sized steps), moments within 1e-4 of
  their largest magnitude.
* The flash kernel's wrapper is called by serving's prefill and never by
  a training step or its backward.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.federated import init_federation as jinit_federation
from repro.launch.steps import make_local_train_step as jlocal_step
from repro.launch.steps import make_train_step as jtrain_step
from repro.models import attention as jattn
from repro.models import init_params as jinit_params
from repro.models import transformer as jtr
from repro.models.layers import cross_entropy_loss as jce
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro_torch import runtime
from repro_torch.configs import get_config
from repro_torch.interop import federation_from_numpy, params_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch.serve import generate
from repro_torch.launch.steps import (
    client_slice,
    make_local_train_step,
    make_train_step,
)
from repro_torch.models import attention as tattn
from repro_torch.models.layers import cross_entropy_loss
from repro_torch.models.transformer import model_view, train_loss
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.utils import tree_leaves, tree_leaves_with_path

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One host thread: the tensors here are small, and parallel test
    workers must not oversubscribe the CPU."""
    with runtime.pinned_threads(1):
        yield


def tiny_cfgs(chunk=None):
    """(reference config, port config): the reference tests' tiny_cfg,
    with ``attn_chunk`` set where given."""
    cfgs = [g("qwen2_0_5b").reduced(n_layers=1, max_d_model=64, max_vocab=64)
            for g in (jget_config, get_config)]
    if chunk is not None:
        cfgs = [dataclasses.replace(c, attn_chunk=chunk) for c in cfgs]
    return cfgs


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def token_batch(rng, lead, seq, vocab=64):
    toks = rng.integers(0, vocab, lead + (seq + 1,)).astype(np.int32)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


def torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)).long() for k, v in batch.items()}


# Adam divides each gradient entry by its own root mean square, so an
# entry whose gradient is near rounding level moves by a rounding-sized
# fraction of lr, in either direction, in either package.  After training
# (``move`` = lr x steps, the most Adam moves an entry) every entry is
# held within 2 x move of the reference, and all but max(2, 1e-4 of the
# leaf) entries within 1e-5 of the leaf's largest magnitude or
# 1e-2 x move, whichever is larger.  The key bias's true gradient is zero
# (q . (k_j + b) - q . k_j is the same for every key j, and the softmax
# ignores it): its gradient is rounding noise in both packages, so that
# leaf is held within 2 x move alone, and its moments within 10x their
# largest magnitude.  Without ``move`` every entry is held to ``rel``.
NOISE_LEAVES = ("layers/attn/bk",)


def assert_tree_close(got, want, rel=1e-5, move=None):
    for (path, g), w in zip(tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(want)):
        g = g.detach().float().numpy()
        w = np.asarray(w, np.float32)
        scale = float(np.abs(w).max())
        tight = rel * max(1e-6, scale)
        if path.endswith(NOISE_LEAVES):
            bound = 2 * move if move is not None else 10 * scale
            np.testing.assert_allclose(g, w, rtol=0, atol=bound,
                                       err_msg=path)
            continue
        if move is None:
            np.testing.assert_allclose(g, w, rtol=rel, atol=tight,
                                       err_msg=path)
            continue
        np.testing.assert_allclose(g, w, rtol=0, atol=2 * move, err_msg=path)
        off = np.abs(g - w) > max(tight, 1e-2 * move) + rel * np.abs(w)
        assert off.sum() <= max(2, 1e-4 * off.size), (
            f"{path}: {off.sum()} of {off.size} entries off")


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = rng.random((2, 5)) < 0.6
    for m in (None, mask, np.zeros_like(mask)):
        want = float(jce(jnp.asarray(logits), jnp.asarray(labels),
                         None if m is None else jnp.asarray(m)))
        got = float(cross_entropy_loss(
            torch.from_numpy(logits), torch.from_numpy(labels),
            None if m is None else torch.from_numpy(m)))
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


@pytest.mark.parametrize("sq,skv,window,causal,chunk", [
    (16, 16, None, True, 1024), (7, 12, 4, True, 1024),
    (12, 12, None, False, 1024), (64, 64, None, True, 16),
    (64, 64, 20, True, 16), (48, 48, None, False, 8)])
def test_train_attention_matches_reference(sq, skv, window, causal, chunk):
    rng = np.random.default_rng(sq + skv)
    q = rng.normal(size=(2, 4, sq, 8)).astype(np.float32)
    k = rng.normal(size=(2, 2, skv, 8)).astype(np.float32)
    v = rng.normal(size=(2, 2, skv, 8)).astype(np.float32)
    off = skv - sq
    want = np.asarray(jattn.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, q_offset=off, chunk=chunk))
    got = tattn.train_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window, q_offset=off, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_train_attention_dispatches_like_the_reference(monkeypatch):
    calls = []
    real = tattn.chunked_attention
    monkeypatch.setattr(tattn, "chunked_attention",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    x = torch.zeros((1, 2, 48, 8))
    tattn.train_attention(x, x, x, chunk=16)          # 48 > 32, 48 % 16 == 0
    tattn.train_attention(x, x, x, chunk=24)          # 48 == 2 * 24: direct
    tattn.train_attention(x[:, :, :40], x, x, chunk=8)  # sq != skv: direct
    tattn.train_attention(x, x, x, chunk=0)           # chunk 0: direct
    assert [c["chunk_q"] for c in calls] == [16]


@pytest.mark.parametrize("seq,chunk", [(16, None), (80, 16)],
                         ids=["direct", "chunked"])
@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_train_loss_and_grads_match_reference(seq, chunk, remat):
    jcfg, tcfg = tiny_cfgs(chunk)
    params = jinit_params(jax.random.PRNGKey(1), jcfg)
    batch = token_batch(np.random.default_rng(seq), (2,), seq)
    jloss, jgrads = jax.value_and_grad(lambda p: jtr.train_loss(
        p, jcfg, jax.tree_util.tree_map(jnp.asarray, batch),
        remat=remat))(params)
    tparams = params_from_numpy(numpy_tree(params), CPU)
    live = [l.requires_grad_(True) for l in tree_leaves(tparams)]
    tloss = train_loss(tparams, tcfg, torch_batch(batch), remat=remat)
    grads = torch.autograd.grad(tloss, live)
    assert abs(float(tloss) - float(jloss)) <= 1e-5 * float(jloss)
    for g, w in zip(grads, jax.tree_util.tree_leaves(jgrads)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()))


def test_unknown_remat_name_raises():
    _, tcfg = tiny_cfgs()
    params = params_from_numpy(numpy_tree(jinit_params(
        jax.random.PRNGKey(0), tiny_cfgs()[0])), CPU)
    with pytest.raises(ValueError, match="remat"):
        train_loss(params, tcfg, torch_batch(token_batch(
            np.random.default_rng(0), (1,), 4)), remat="offload")


def test_single_model_train_step_matches_reference():
    jcfg, tcfg = tiny_cfgs()
    opt = dict(lr=1e-3, weight_decay=0.1)
    params = jinit_params(jax.random.PRNGKey(2), jcfg)
    jstate = jadamw_init(params)
    tparams = params_from_numpy(numpy_tree(params), CPU)
    tstate = adamw_init(tparams)
    jstep = jax.jit(jtrain_step(jcfg, JAdamWConfig(**opt), remat="full"))
    tstep = make_train_step(tcfg, AdamWConfig(**opt), remat="full")
    rng = np.random.default_rng(3)
    for _ in range(3):
        batch = token_batch(rng, (2,), 16)
        jl, params, jstate = jstep(params, jstate,
                                   jax.tree_util.tree_map(jnp.asarray, batch))
        tl, tparams, tstate = tstep(tparams, tstate, batch)
        assert abs(float(tl) - float(jl)) <= 1e-5 * float(jl)
    assert_tree_close(tparams, params, move=3 * opt["lr"])
    assert_tree_close(tstate["mu"], jstate["mu"])


def test_four_local_steps_on_four_clients_match_reference():
    jcfg, tcfg = tiny_cfgs()
    opt = dict(lr=1e-3, weight_decay=0.0)
    jstate = jinit_federation(jax.random.PRNGKey(0), jcfg, 4, same_init=False)
    state = federation_from_numpy(numpy_tree(jstate.params),
                                  numpy_tree(jstate.opt_state), device=CPU)
    views_before = [l.data_ptr() for l in tree_leaves(state.params)]
    jstep = jax.jit(jlocal_step(jcfg, JAdamWConfig(**opt), remat="none"))
    tstep = make_local_train_step(tcfg, AdamWConfig(**opt), remat="none")
    rng = np.random.default_rng(4)
    jp, jo = jstate.params, jstate.opt_state
    tp, to = state.params, state.opt_state
    for _ in range(4):
        batch = token_batch(rng, (4, 2), 16)
        jl, jp, jo = jstep(jp, jo, jax.tree_util.tree_map(jnp.asarray, batch))
        tl, tp, to = tstep(tp, to, batch)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    assert_tree_close(tp, jp, move=4 * opt["lr"])
    # the later steps' gradients are taken at parameters that differ by
    # the bound above, so the moments are held to 1e-4 of their largest
    assert_tree_close(to["mu"], jo["mu"], rel=1e-4)
    assert_tree_close(to["nu"], jo["nu"], rel=1e-4)
    assert to["step"].tolist() == np.asarray(jo["step"]).tolist() == [4] * 4
    # the step ran in place: the stacked buffers are the ones given
    assert [l.data_ptr() for l in tree_leaves(tp)] == views_before


def test_gradients_stay_within_each_client():
    """A batch change for client 0 moves client 0's model alone."""
    _, tcfg = tiny_cfgs()
    jstate = jinit_federation(jax.random.PRNGKey(5), tiny_cfgs()[0], 3)
    rng = np.random.default_rng(6)
    batch = token_batch(rng, (3, 2), 8)
    other = {k: v.copy() for k, v in batch.items()}
    other["labels"][0] = (other["labels"][0] + 1) % 64
    runs = []
    for b in (batch, other):
        st = federation_from_numpy(numpy_tree(jstate.params),
                                   numpy_tree(jstate.opt_state), device=CPU)
        make_local_train_step(tcfg, AdamWConfig(), remat="none")(
            st.params, st.opt_state, b)
        runs.append(st.params)
    pairs = list(zip(tree_leaves(runs[0]), tree_leaves(runs[1])))
    assert any(not torch.equal(a[0], b[0]) for a, b in pairs)
    assert all(torch.equal(a[1:], b[1:]) for a, b in pairs)


def test_training_never_calls_flash_and_serving_prefill_does(monkeypatch):
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    jcfg, tcfg = tiny_cfgs()
    jstate = jinit_federation(jax.random.PRNGKey(0), jcfg, 2)
    state = federation_from_numpy(numpy_tree(jstate.params),
                                  numpy_tree(jstate.opt_state), device=CPU)
    make_local_train_step(tcfg, remat="full")(
        state.params, state.opt_state,
        token_batch(np.random.default_rng(0), (2, 2), 16))
    assert calls == []
    model = model_view(client_slice(state.params, 0), tcfg)
    generate(model, tcfg, torch.zeros((1, 6), dtype=torch.long), 3,
             device=CPU)
    assert len(calls) == tcfg.n_layers           # the prefill, once a layer
