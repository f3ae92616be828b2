"""The port's dense decoder LM against the reference's, on the reduced
qwen2-0.5b (2 layers, d_model 512, 14 query / 2 KV heads of 36, d_ff
2779, vocab 1024, serve_window 64, float32) with the reference's
weights carried across (``repro_torch.interop.model_from_numpy``).

Tolerances: building blocks within rtol/atol 1e-5 (one fp32 op or two
apart); attention within rtol/atol 1e-4 (the kernel's reference test);
logits, ring caches and decode logits within 1e-4 of the largest
magnitude (every matmul sums in another order in the two frameworks).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro_torch import runtime
from repro_torch.configs import get_config as tget_config
from repro_torch.interop import model_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One host thread: the tensors here are small, and parallel test
    workers must not oversubscribe the CPU."""
    with runtime.pinned_threads(1):
        yield


ARCH = "qwen2-0.5b"


def _close(got, want, rel=1e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= rel * float(np.abs(want).max()), (err, rel)


@pytest.fixture(scope="module")
def models():
    cfg = get_config(ARCH).reduced()
    tcfg = tget_config(ARCH).reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    params = jtf.init_params(jax.random.PRNGKey(0), cfg)
    # the reference zero-inits norms and biases: perturb them so the
    # (1 + scale) gains and the QKV bias are exercised
    rng = np.random.default_rng(7)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    for name in ("ln1", "ln2"):
        np_params["layers"][name] = 0.1 * rng.normal(
            size=np_params["layers"][name].shape).astype(np.float32)
    for name in ("bq", "bk", "bv"):
        np_params["layers"]["attn"][name] = 0.1 * rng.normal(
            size=np_params["layers"]["attn"][name].shape).astype(np.float32)
    np_params["final_norm"] = 0.1 * rng.normal(
        size=np_params["final_norm"].shape).astype(np.float32)
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    return cfg, tcfg, params, model_from_numpy(np_params, tcfg, "cpu")


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


def test_rms_norm_matches():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 512)).astype(np.float32) * 3.0
    scale = rng.normal(size=(512,)).astype(np.float32)
    got = tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale))
    want = jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# positions up to the serving prompt's 8192: there an fp32 angle has an
# ulp of 4.9e-4 rad, and the two frameworks' sin/cos reduce such angles
# differently (2.2e-5 apart at most here), hence atol 1e-4 above 128
@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
@pytest.mark.parametrize("max_pos,atol", [(128, 1e-5), (8192, 1e-4)])
def test_rope_matches(theta, max_pos, atol):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 6, 14, 36)).astype(np.float32)
    pos = rng.integers(0, max_pos, (2, 6))
    got = tlayers.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = jlayers.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=atol)


def test_mlp_forward_matches(models):
    cfg, _, params, model = models
    x = np.random.default_rng(2).normal(size=(2, 7, 512)).astype(np.float32)
    mlp = jax.tree_util.tree_map(lambda a: a[1], params["layers"]["mlp"])
    want = jlayers.mlp_forward(mlp, jnp.asarray(x), cfg.mlp_variant)
    got = tlayers.mlp_forward(model.layers[1].mlp, torch.from_numpy(x),
                              cfg.mlp_variant)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_qkv_and_out_proj_match(models):
    cfg, tcfg, params, model = models
    x = np.random.default_rng(3).normal(size=(2, 9, 512)).astype(np.float32)
    attn = jax.tree_util.tree_map(lambda a: a[0], params["layers"]["attn"])
    want = jattn.qkv_proj(attn, jnp.asarray(x), cfg)
    got = tattn.qkv_proj(model.layers[0].attn, torch.from_numpy(x), tcfg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    o = np.random.default_rng(4).normal(size=(2, 14, 9, 36)).astype(
        np.float32)
    np.testing.assert_allclose(
        tattn.out_proj(model.layers[0].attn, torch.from_numpy(o)).numpy(),
        np.asarray(jattn.out_proj(attn, jnp.asarray(o))), rtol=1e-5,
        atol=1e-5)


# s = 32 with chunk 8 takes the reference's chunked scan, s = 20 its
# direct einsum; the port runs the same (kernel-plain) function for both
@pytest.mark.parametrize("s,window", [(32, None), (32, 5), (20, None),
                                      (20, 7)])
def test_attention_matches_both_reference_paths(s, window):
    rng = np.random.default_rng(s + (window or 0))
    q = rng.normal(size=(2, 14, s, 36)).astype(np.float32)
    k = rng.normal(size=(2, 2, s, 36)).astype(np.float32)
    v = rng.normal(size=(2, 2, s, 36)).astype(np.float32)
    want = jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=True, window=window, chunk=8)
    got = tattn.attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True, window=window,
                          chunk=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_attention_refuses_an_offset_the_kernel_would_not_use():
    q = torch.zeros((1, 2, 4, 8))
    k = torch.zeros((1, 2, 6, 8))
    with pytest.raises(ValueError, match="q_offset"):
        tattn.attention(q, k, k, q_offset=0)
    assert tattn.attention(q, k, k, q_offset=2).shape == (1, 2, 4, 8)


@pytest.mark.parametrize("pos,cap", [(0, 4), (3, 4), (9, 4), (80, 64)])
def test_ring_positions_match(pos, cap):
    np.testing.assert_array_equal(
        tattn._ring_positions(pos, cap).numpy(),
        np.asarray(jattn._ring_positions(jnp.int32(pos), cap)))


def _prefill(models, s, capacity, seed=10):
    cfg, tcfg, params, model = models
    toks = _tokens(seed, 2, s, cfg.vocab_size)
    jl, jc = jax.jit(lambda p, t: jtf.prefill_with_cache(
        p, cfg, {"tokens": t}, capacity=capacity))(params, jnp.asarray(toks))
    with torch.inference_mode():
        tl, tc = ttf.prefill_with_cache(model, tcfg,
                                        {"tokens": torch.from_numpy(toks)},
                                        capacity=capacity)
    return (jl, jc), (tl, tc)


# s = 80 passes the serve window of 64, so the window bites; capacity
# below s rolls the ring (s = 48, cap 40: shift 8; s = 80, cap 64: 16)
@pytest.mark.parametrize("s,capacity", [(48, 40), (80, 64), (48, 56)])
def test_prefill_with_cache_matches(models, s, capacity):
    (jl, jc), (tl, tc) = _prefill(models, s, capacity)
    _close(tl.numpy(), jl)
    assert tc.pos == int(jc.pos) == s
    for i, layer in enumerate(tc.layers):
        assert layer["k"].shape == (2, 2, capacity, 36)
        _close(layer["k"].numpy(), jc.layers["k"][i])
        _close(layer["v"].numpy(), jc.layers["v"][i])


def test_decode_steps_match(models):
    cfg, tcfg, params, model = models
    (_, jc), (_, tc) = _prefill(models, 80, 64)
    step = jax.jit(lambda p, c, t: jtf.decode_step(p, cfg, c, t))
    toks = _tokens(11, 2, 8, cfg.vocab_size)
    for t in range(8):
        jl, jc = step(params, jc, jnp.asarray(toks[:, t:t + 1]))
        with torch.inference_mode():
            tl, tc = ttf.decode_step(model, tcfg, tc,
                                     torch.from_numpy(toks[:, t:t + 1]))
        _close(tl.numpy(), jl)
    assert tc.pos == int(jc.pos) == 88
    for i, layer in enumerate(tc.layers):
        _close(layer["k"].numpy(), jc.layers["k"][i])
        _close(layer["v"].numpy(), jc.layers["v"][i])


def test_decode_matches_forward_and_prefill(models):
    """The port alone: prefill over 10 tokens then 6 decode steps give
    the logits of one forward over all 16, and a prefill over the prompt
    plus the decoded tokens gives the last decode step's logits."""
    _, tcfg, _, model = models
    cfg = dataclasses.replace(tcfg, serve_window=None)
    toks = torch.from_numpy(_tokens(12, 2, 16, cfg.vocab_size))
    with torch.inference_mode():
        full, aux = ttf.forward(model, cfg, {"tokens": toks})
        assert float(aux) == 0.0
        logits, cache = ttf.prefill_with_cache(
            model, cfg, {"tokens": toks[:, :10]}, capacity=16)
        _close(logits.numpy(), full[:, :10].numpy())
        for t in range(10, 16):
            lg, cache = ttf.decode_step(model, cfg, cache, toks[:, t:t + 1])
            _close(lg[:, 0].numpy(), full[:, t].numpy())
        again, _ = ttf.prefill_with_cache(model, cfg, {"tokens": toks})
        _close(lg[:, 0].numpy(), again[:, -1].numpy())


def test_fresh_init_has_the_reference_shapes(models):
    cfg, tcfg, params, _ = models
    model = ttf.init_params(tcfg, seed=3, device="cpu")
    want = {"embed": params["embed"].shape,
            "final_norm": params["final_norm"].shape}
    assert {k: tuple(getattr(model, k).shape) for k in want} == want
    for name, w in params["layers"]["attn"].items():
        assert tuple(getattr(model.layers[0].attn, name).shape) == \
            w.shape[1:]
    assert tuple(model.layers[1].mlp.w_in.shape) == \
        params["layers"]["mlp"]["w_in"].shape[1:]
    assert len(model.layers) == cfg.n_layers
    assert model.embed.dtype == torch.float32
    assert float(model.embed.std()) == pytest.approx(0.02, rel=0.05)


# the other dense decoders: gemma-2b (GeGLU with the tanh gelu, one KV
# head, head_dim 64 after the cut) and yi-9b (no QKV bias, untied head)
@pytest.mark.parametrize("arch", ["gemma-2b", "yi-9b"])
def test_other_dense_decoders_match(arch):
    cfg = get_config(arch).reduced()
    tcfg = tget_config(arch).reduced()
    params = jtf.init_params(jax.random.PRNGKey(2), cfg)
    model = model_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                             tcfg, "cpu")
    toks = _tokens(13, 2, 24, cfg.vocab_size)
    want, jc = jtf.prefill_with_cache(params, cfg,
                                      {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        got, tc = ttf.prefill_with_cache(model, tcfg,
                                         {"tokens": torch.from_numpy(toks)})
    _close(got.numpy(), want)
    _close(tc.layers[1]["v"].numpy(), jc.layers["v"][1])
