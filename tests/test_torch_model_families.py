"""Every configuration of ``configs/`` through the port's model entry
points against the reference's, on the same numpy weights and inputs:
each config reduced to 2 layers (xLSTM: one m + s pair), d_model 128,
vocab 256, fp32, with the reference's weights carried across by
``interop.model_from_numpy``.  deepseek-moe-16b keeps 8 experts (top
6), so routing chooses; xlstm-125m runs its mLSTM in chunks of 8 and
hymba-1.5b its SSM in chunks of 16, so the chunked paths and their
carried states run.

Per config: ``forward`` (logits and the MoE aux loss), ``train_loss``
and its gradients, and for every causal config ``prefill_with_cache``
over 32 tokens then 8 ``decode_step``s (logits and every cache entry).
Tolerances: logits, caches and gradients within 1e-4 of their largest
magnitude (fp32 in other summation orders, through two layers; the
SSM's doubling scan adds in another order than the reference's
associative scan), losses within rtol 1e-5, the aux loss within 1e-6.
A MoE router whose k-th and (k+1)-th probabilities lie within rounding
could choose another expert in the other framework, so every MoE run
first asserts that its smallest top-k margin, in every layer, is above
1e-4.

Also: the parameter trees (paths, flatten order, shapes, dtypes) are
the reference's; the fp32 leaves stay fp32 in a bf16 model; the MoE
router-invariant sketch filter keeps the reference's leaves; a stacked
MoE and hybrid federation's checkpoint round-trips both ways; one
in-place AdamW step of a MoE model equals the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs import get_config as jget_config
from repro.core.federated import _router_invariant_filter as jfilter
from repro.launch.steps import make_train_step as jtrain_step
from repro.models import transformer as jtf
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro_torch import runtime
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get_config as tget_config
from repro_torch.core.federated import _router_invariant_filter as tfilter
from repro_torch.interop import model_from_numpy, params_from_numpy
from repro_torch.launch.steps import make_train_step
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.utils import tree_leaves, tree_leaves_with_path, tree_map

from test_torch_train_step import assert_tree_close

SEQ, PROMPT, GEN = 48, 32, 8
MARGIN = 1e-4
CAUSAL = [a for a in ARCH_IDS if tget_config(a).causal]
# the input seeds of the forward, the loss and the prefill tests: seeds
# whose inputs keep every top-k margin of the reduced MoE configs above
# MARGIN in the port's run (which the tests assert)
FORWARD_SEED, LOSS_SEED, PREFILL_SEED = 0, 3, 5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One host thread: the tensors here are small, and parallel test
    workers must not oversubscribe the CPU."""
    with runtime.pinned_threads(1):
        yield


def reduced_cfgs(arch, dtype="float32"):
    """(reference config, port config) of ``arch`` cut as above."""
    kw = {"max_experts": 8} if arch == "deepseek_moe_16b" else {}
    extra = {"mlstm_chunk": 8, "ssm_chunk": 16, "dtype": dtype}
    return [dataclasses.replace(
        g(arch).reduced(max_d_model=128, max_vocab=256, **kw), **extra)
        for g in (jget_config, tget_config)]


def _close(got, want, rel=1e-4, what=""):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= rel * max(float(np.abs(want).max()), 1e-30), (what, err)


def make_batch(cfg, seed, s, b=2):
    """Numpy inputs for ``cfg``'s input mode: tokens and next-token labels;
    audio frames with a 30 % frame mask and codebook labels; tokens with
    5 patch embeddings at distinct positions a row."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1))
    if cfg.input_mode == "embeddings":
        return {"frames": rng.normal(size=(b, s, ttf.FRONTEND_DIM)).astype(
                    np.float32),
                "mask": rng.random((b, s)) < 0.3,
                "labels": toks[:, :s]}
    batch = {"tokens": toks[:, :s], "labels": toks[:, 1:]}
    if cfg.input_mode == "multimodal":
        batch["patch_embeds"] = rng.normal(
            size=(b, 5, ttf.PATCH_DIM)).astype(np.float32)
        batch["patch_positions"] = np.stack(
            [rng.permutation(PROMPT)[:5] for _ in range(b)])
    return batch


def as_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def as_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.fixture(scope="module", params=ARCH_IDS)
def family(request):
    arch = request.param
    cfg, tcfg = reduced_cfgs(arch)
    params = jtf.init_params(jax.random.PRNGKey(3), cfg)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    model = model_from_numpy(np_params, tcfg, "cpu")
    return arch, cfg, tcfg, params, np_params, model


@pytest.fixture
def router_margins(monkeypatch):
    """Every top-k margin the port's router sees while the test runs."""
    seen = []
    route = tmoe.route

    def recording(x, router, k):
        probs, topv, topi = route(x, router, k)
        if k < probs.shape[-1]:          # top k of k experts: no choice
            top = torch.topk(probs.detach(), k + 1, dim=-1).values
            seen.append(float((top[..., k - 1] - top[..., k]).min()))
        return probs, topv, topi

    monkeypatch.setattr(tmoe, "route", recording)
    return seen


def test_forward_matches(family, router_margins):
    _, cfg, tcfg, params, _, model = family
    batch = make_batch(cfg, FORWARD_SEED, SEQ)
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    want, jaux = jax.jit(lambda p, b: jtf.forward(p, cfg, b))(
        params, as_jax(inputs))
    with torch.no_grad():
        got, aux = ttf.forward(model, tcfg, as_torch(inputs))
    assert min(router_margins, default=1.0) > MARGIN
    _close(got, want, what="logits")
    assert aux.dtype == torch.float32 and aux.ndim == 0
    assert float(aux) == pytest.approx(float(jaux), rel=1e-6, abs=1e-12)
    assert (float(aux) > 0) == cfg.is_moe


def test_train_loss_and_grads_match(family, router_margins):
    _, cfg, tcfg, params, np_params, _ = family
    batch = make_batch(cfg, LOSS_SEED, SEQ)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jtf.train_loss(p, cfg, b)))(params, as_jax(batch))
    live = tree_map(lambda l: l.requires_grad_(True),
                    params_from_numpy(np_params, "cpu"))
    loss = ttf.train_loss(live, tcfg, as_torch(batch))
    grads = torch.autograd.grad(loss, tree_leaves(live), allow_unused=True,
                                materialize_grads=True)
    assert min(router_margins, default=1.0) > MARGIN
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    for (path, _), g, w in zip(tree_leaves_with_path(live), grads,
                               jax.tree_util.tree_leaves(jgrads)):
        _close(g, w, what=path)


@pytest.mark.parametrize("family", CAUSAL, indirect=True)
def test_prefill_and_decode_match(family, router_margins):
    _, cfg, tcfg, params, _, model = family
    batch = make_batch(cfg, PREFILL_SEED, PROMPT + GEN)
    prompt = {k: v[:, :PROMPT] if k == "tokens" else v
              for k, v in batch.items() if k != "labels"}
    cap = PROMPT + GEN
    jl, jc = jax.jit(lambda p, b: jtf.prefill_with_cache(
        p, cfg, b, capacity=cap))(params, as_jax(prompt))
    with torch.no_grad():
        tl, tc = ttf.prefill_with_cache(model, tcfg, as_torch(prompt),
                                        capacity=cap)
    _close(tl, jl, what="prefill logits")
    step = jax.jit(lambda p, c, t: jtf.decode_step(p, cfg, c, t))
    toks = batch["tokens"]
    for t in range(PROMPT, PROMPT + GEN):
        jl, jc = step(params, jc, jnp.asarray(toks[:, t:t + 1]))
        with torch.no_grad():
            tl, tc = ttf.decode_step(model, tcfg, tc,
                                     torch.from_numpy(toks[:, t:t + 1]))
        _close(tl, jl, what=f"decode {t}")
    assert min(router_margins, default=1.0) > MARGIN
    assert tc.pos == int(jc.pos) == PROMPT + GEN
    assert len(tc.layers) == ttf.n_stack(tcfg)
    for i, layer in enumerate(tc.layers):
        assert sorted(layer) == sorted(jc.layers)
        for name, t in layer.items():
            want = jc.layers[name][i]
            assert str(t.dtype).split(".")[-1] == want.dtype.name, name
            _close(t, want, what=f"layer {i} {name}")


@pytest.mark.parametrize("family", CAUSAL, indirect=True)
def test_init_decode_cache_matches_the_reference_layout(family):
    _, cfg, tcfg, *_ = family
    want = jtf.init_decode_cache(cfg, 2, 24)
    got = ttf.init_decode_cache(tcfg, 2, 24, device="cpu")
    assert got.pos == 0 and len(got.layers) == ttf.n_stack(tcfg)
    for name, leaf in want.layers.items():
        t = got.layers[0][name]
        assert tuple(t.shape) == leaf.shape[1:], name
        assert str(t.dtype).split(".")[-1] == leaf.dtype.name, name
        assert not t.any()


def _ref_paths(tree):
    return [("/".join(str(p.key) for p in path), leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_parameter_tree_is_the_references(arch, dtype):
    """init_tree's key paths, in flatten order, with the reference's
    shapes and dtypes; init_params' modules hold the same leaves."""
    cfg, tcfg = reduced_cfgs(arch, dtype)
    want = _ref_paths(jtf.abstract_params(cfg))
    tree = ttf.init_tree(tcfg, seed=0, device="cpu")
    got = tree_leaves_with_path(tree)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, t), (_, w) in zip(got, want):
        assert tuple(t.shape) == w.shape, path
        assert str(t.dtype).split(".")[-1] == w.dtype.name, path
    model = ttf.init_params(tcfg, seed=0, device="cpu")
    back = ttf.tree_from_model(model)
    for a, b in zip(tree_leaves(back), tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "hymba_1_5b"])
def test_fp32_leaves_stay_fp32_in_a_bf16_model(arch):
    """The MoE router and the SSM's a_log and d_skip are fp32 at any
    model dtype in the reference; so in the port, through
    ``model_from_numpy``, ``init_params`` and ``init_tree``."""
    cfg, tcfg = reduced_cfgs(arch, "bfloat16")
    ref = jax.tree_util.tree_map(
        np.asarray, jtf.init_params(jax.random.PRNGKey(0), cfg))
    fp32 = {p for p, l in _ref_paths(ref) if l.dtype == np.float32}
    assert fp32 and all(p.endswith(ttf.FP32_LEAVES) for p in fp32)
    built = model_from_numpy(ref, tcfg, "cpu")
    for tree in (ttf.tree_from_model(built),
                 ttf.tree_from_model(ttf.init_params(tcfg, device="cpu")),
                 ttf.init_tree(tcfg, device="cpu")):
        for path, t in tree_leaves_with_path(tree):
            want = torch.float32 if path in fp32 else torch.bfloat16
            assert t.dtype == want, path
    router = ttf.tree_from_model(built)["layers"].get("moe", {}).get("router")
    if router is not None:
        assert torch.equal(router, torch.from_numpy(
            ref["layers"]["moe"]["router"]))


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "grok_1_314b"])
def test_router_invariant_filter_keeps_the_references_leaves(arch):
    """The MoE sketch drops every per-expert tensor, the shared experts'
    too (their path holds ``moe`` and ``w_in``), and keeps the router."""
    cfg, tcfg = reduced_cfgs(arch)
    flat = jax.tree_util.tree_flatten_with_path(jtf.abstract_params(cfg))[0]
    want = ["/".join(str(p.key) for p in path)
            for path, leaf in flat if jfilter(path, leaf)]
    tree = ttf.init_tree(tcfg, device="cpu")
    got = [p for p, l in tree_leaves_with_path(tree) if tfilter(p, l)]
    assert got == want
    assert "layers/moe/router" in got
    assert not any(p.startswith("layers/moe/") and p != "layers/moe/router"
                   for p in got)


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "hymba_1_5b"])
def test_checkpoint_round_trips_both_ways(tmp_path, arch):
    """A stacked bf16 federation of 2 clients (fp32 router / a_log /
    d_skip inside) written by either package is read by the other bit
    for bit."""
    cfg, tcfg = reduced_cfgs(arch, "bfloat16")
    ref = jax.tree_util.tree_map(
        lambda *ls: jnp.stack(ls),
        *[jtf.init_params(jax.random.PRNGKey(s), cfg) for s in (0, 1)])
    jckpt.save_checkpoint(str(tmp_path / "ref"), 5, ref)
    got = restore_checkpoint(str(tmp_path / "ref"), 5, ref)
    for (path, t), r in zip(tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(ref)):
        r = np.asarray(r)
        assert str(t.dtype).split(".")[-1] == r.dtype.name, path
        assert t.contiguous().view(torch.uint8).numpy().tobytes() == \
            r.tobytes(), path
    save_checkpoint(str(tmp_path / "port"), 6, got)
    back = jckpt.restore_checkpoint(str(tmp_path / "port"), 6, ref)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(ref)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_one_adamw_step_of_a_moe_model_matches():
    """``launch.steps.make_train_step`` (in place) against the
    reference's, one step of the reduced deepseek-moe-16b in fp32; then
    in bf16 the router stays fp32 and moves."""
    cfg, tcfg = reduced_cfgs("deepseek_moe_16b")
    opt = dict(lr=1e-3, weight_decay=0.1)
    params = jtf.init_params(jax.random.PRNGKey(4), cfg)
    batch = make_batch(cfg, 4, 16)
    jloss, jparams, jstate = jax.jit(jtrain_step(
        cfg, JAdamWConfig(**opt), remat="none"))(
        params, jadamw_init(params), as_jax(batch))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                "cpu")
    tstate = adamw_init(tparams)
    loss, out, state = make_train_step(tcfg, AdamWConfig(**opt),
                                       remat="none")(tparams, tstate, batch)
    assert out is tparams and state is tstate
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    assert_tree_close(tparams, jparams, move=opt["lr"])
    assert_tree_close(tstate["mu"], jstate["mu"], rel=1e-4)

    _, bcfg = reduced_cfgs("deepseek_moe_16b", "bfloat16")
    bparams = ttf.init_tree(bcfg, device="cpu")
    router = bparams["layers"]["moe"]["router"].clone()
    make_train_step(bcfg, AdamWConfig(**opt))(bparams, adamw_init(bparams),
                                              batch)
    for path, t in tree_leaves_with_path(bparams):
        assert t.dtype == ttf.leaf_dtype(path, bcfg), path
    assert not torch.equal(bparams["layers"]["moe"]["router"], router)
