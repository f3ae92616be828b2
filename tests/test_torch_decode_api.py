"""The reference's one-layer decode API in the port: ``KVCache``,
``init_kv_cache`` and ``decode_attention`` (``models/attention.py``), and
``layers.init_mlp``, against the JAX reference on the CPU.

``decode_attention`` runs on qwen2-0.5b's attention cut to d_model 64,
4 query heads over 2 KV heads of 16 (GQA), with its QKV bias, a ring of
capacity 8 and a serve window of 6 (shorter than the ring), for 12 steps
from position 0 (an empty ring) and from position 5 (a ring of random K
and V carried across by ``interop.kv_cache_from_numpy``): both runs pass
the wrap.  Tolerances, of the largest magnitude of each output and ring:
1e-5 in float32; 2^-7 (one bfloat16 ulp) in bfloat16, where the two
frameworks round the projections to bfloat16 after summing in other
orders.  The port's decode equals its own windowed causal ``attention``
over the same K and V (teacher forcing) within 1e-5, returns a cache
that shares the ring it was given, and reads nothing on the host.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch import runtime
from repro_torch.configs import get_config as tget_config
from repro_torch.interop import kv_cache_from_numpy, tensor_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One host thread: the tensors here are small, and parallel test
    workers must not oversubscribe the CPU."""
    with runtime.pinned_threads(1):
        yield


CPU = "cpu"
B, CAPACITY, WINDOW, STEPS = 2, 8, 6, 12
SHAPE = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
             serve_window=WINDOW)
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}


def cfgs(dtype):
    return tuple(dataclasses.replace(get(ARCH), dtype=dtype, **SHAPE)
                 for get in (get_config, tget_config))


ARCH = "qwen2-0.5b"


def attn_params(rng, cfg):
    d, dh = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.n_heads * dh, cfg.n_kv_heads * dh
    shapes = {"wq": (d, hq), "wk": (d, hkv), "wv": (d, hkv), "wo": (hq, d),
              "bq": (hq,), "bk": (hkv,), "bv": (hkv,)}
    return {k: (0.3 * rng.normal(size=s)).astype(np.float32)
            for k, s in shapes.items()}


def as_ref(arr, dtype):
    """A numpy array in the reference's ``dtype`` (ml_dtypes bfloat16)."""
    return np.asarray(jnp.asarray(arr, dtype))


def close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (err, tol)


def start_cache(rng, start, dtype):
    """The ring at ``start``: zeros at 0, random K and V otherwise."""
    shape = (B, SHAPE["n_kv_heads"], CAPACITY, SHAPE["head_dim"])
    if start == 0:
        k = v = np.zeros(shape, np.float32)
    else:
        k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    return as_ref(k, dtype), as_ref(v, dtype)


@pytest.mark.parametrize("start", [0, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_reference_past_the_wrap(dtype, start):
    rng = np.random.default_rng(start)
    jcfg, tcfg = cfgs(dtype)
    params = attn_params(rng, jcfg)
    jparams = {k: jnp.asarray(v, dtype) for k, v in params.items()}
    tparams = {k: tensor_from_numpy(as_ref(v, dtype), CPU)
               for k, v in params.items()}
    k0, v0 = start_cache(rng, start, dtype)
    jcache = jattn.KVCache(k=jnp.asarray(k0), v=jnp.asarray(v0),
                           pos=jnp.asarray(start, jnp.int32))
    tcache = kv_cache_from_numpy(k0, v0, start, device=CPU)
    assert tcache.pos.dtype == torch.int32 and tcache.pos.ndim == 0
    tol = TOL[dtype]
    for _ in range(STEPS):
        x = as_ref(rng.normal(size=(B, 1, jcfg.d_model)), dtype)
        jout, jcache = jattn.decode_attention(jparams, jnp.asarray(x),
                                              jcache, jcfg)
        tout, tcache = tattn.decode_attention(
            tparams, tensor_from_numpy(x, CPU), tcache, tcfg)
        assert tout.dtype == getattr(torch, dtype)
        close(tout, jout, tol)
        close(tcache.k, jcache.k, tol)
        close(tcache.v, jcache.v, tol)
        assert int(tcache.pos) == int(jcache.pos)
    assert int(tcache.pos) == start + STEPS > CAPACITY


def test_decode_equals_teacher_forced_attention():
    """Decode from an empty ring equals the windowed causal ``attention``
    over the prompt's K and V (RoPE at positions 0..STEPS-1)."""
    rng = np.random.default_rng(1)
    _, cfg = cfgs("float32")
    params = {k: torch.from_numpy(v) for k, v in attn_params(rng, cfg).items()}
    xs = torch.from_numpy(rng.normal(size=(B, STEPS, cfg.d_model)).astype(
        np.float32))
    cache = tattn.init_kv_cache(B, cfg.n_kv_heads, CAPACITY,
                                cfg.resolved_head_dim, torch.float32,
                                device=CPU)
    steps = []
    for t in range(STEPS):
        out, cache = tattn.decode_attention(params, xs[:, t:t + 1], cache,
                                            cfg)
        steps.append(out)
    view = SimpleNamespace(**params)
    q, k, v = tattn.qkv_proj(view, xs, cfg)
    pos = torch.arange(STEPS)[None].expand(B, STEPS)
    q = tattn.rope_transpose(q, pos, cfg.rope_theta)
    k = tattn.rope_transpose(k, pos, cfg.rope_theta)
    want = tattn.out_proj(view, tattn.attention(q, k, v, causal=True,
                                                window=WINDOW))
    close(torch.cat(steps, dim=1), want.numpy(), 1e-5)


def test_decode_shares_the_ring_and_reads_nothing_on_the_host(monkeypatch):
    """The returned cache holds the same k and v storage (written in
    place) and a new pos; no step converts a tensor to a Python value."""
    rng = np.random.default_rng(2)
    _, cfg = cfgs("float32")
    params = {k: torch.from_numpy(v) for k, v in attn_params(rng, cfg).items()}
    def ring():
        return tattn.init_kv_cache(B, cfg.n_kv_heads, CAPACITY,
                                   cfg.resolved_head_dim, torch.float32,
                                   pos=9, device=CPU)

    x = torch.from_numpy(rng.normal(size=(B, 1, cfg.d_model)).astype(
        np.float32))
    tattn.decode_attention(params, x, ring(), cfg)    # RoPE's table cached

    def host_read(*_a, **_k):
        raise AssertionError("decode_attention read a tensor on the host")

    cache = ring()
    for name in ("item", "tolist", "numpy", "__int__", "__index__",
                 "__float__", "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, host_read)
    new = tattn.decode_attention(params, x, cache, cfg)[1]
    monkeypatch.undo()
    assert new.k.data_ptr() == cache.k.data_ptr()
    assert new.v.data_ptr() == cache.v.data_ptr()
    assert int(cache.pos) == 9 and int(new.pos) == 10
    # this step's K and V went to slot 9 % 8 = 1 of the ring passed in
    written = cache.k.abs().sum((0, 1, 3)) > 0
    assert written.tolist() == [i == 1 for i in range(CAPACITY)]
    assert cache.v[:, :, 1].abs().sum() > 0


def test_init_kv_cache_matches_reference():
    want = jattn.init_kv_cache(2, 3, 5, 4, pos=7)
    got = tattn.init_kv_cache(2, 3, 5, 4, pos=7, device=CPU)
    assert tuple(got.k.shape) == want.k.shape == tuple(got.v.shape)
    assert got.k.dtype == torch.bfloat16 and want.k.dtype == jnp.bfloat16
    assert not got.k.any() and not got.v.any()
    assert got.pos.dtype == torch.int32 and int(got.pos) == int(want.pos)


@pytest.mark.parametrize("variant", ["swiglu", "geglu", "relu"])
def test_init_mlp_shapes_scale_and_forward_match_reference(variant):
    """``init_mlp``'s shapes and dtypes are the reference's, its std is
    fan_in^-1/2, and ``mlp_forward`` on the reference's weights carried
    across gives the reference's output within 1e-5."""
    d, f = 64, 96
    want = jlayers.init_mlp(jax.random.PRNGKey(0), d, f, variant,
                            jnp.float32)
    got = tlayers.init_mlp(torch.Generator().manual_seed(0), d, f, variant,
                           torch.float32, device=CPU)
    assert set(got) == set(want) == {"w_in", "w_out"}
    for key in got:
        assert tuple(got[key].shape) == want[key].shape
        fan_in = got[key].shape[0]
        assert float(got[key].std()) == pytest.approx(fan_in ** -0.5,
                                                      rel=0.05)
    wide = tlayers.init_mlp(torch.Generator().manual_seed(0), d, f, variant,
                            torch.bfloat16, device=CPU)
    assert wide["w_in"].dtype == torch.bfloat16
    x = np.random.default_rng(0).normal(size=(2, 3, d)).astype(np.float32)
    ref = jlayers.mlp_forward(want, jnp.asarray(x), variant)
    carried = SimpleNamespace(**{k: torch.from_numpy(np.array(v))
                                       for k, v in want.items()})
    out = tlayers.mlp_forward(carried, torch.from_numpy(x), variant)
    close(out, ref, 1e-5)


def test_init_mlp_is_the_layer_init_draw():
    """A layer's ``mlp`` is ``init_mlp`` on the same generator: the
    transformer's draws are unchanged."""
    from repro_torch.models import transformer as ttf

    cfg = tget_config(ARCH).reduced()
    gen = torch.Generator().manual_seed(3)
    layer = ttf.init_layer_params(gen, cfg)
    gen = torch.Generator().manual_seed(3)
    # replay the draws that precede the MLP's, then draw it
    for shape in [(cfg.d_model, cfg.n_heads * cfg.resolved_head_dim),
                  (cfg.d_model, cfg.n_kv_heads * cfg.resolved_head_dim),
                  (cfg.d_model, cfg.n_kv_heads * cfg.resolved_head_dim),
                  (cfg.n_heads * cfg.resolved_head_dim, cfg.d_model)]:
        tlayers._dense_init(gen, shape, torch.float32)
    mlp = tlayers.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_variant,
                           ttf.torch_dtype(cfg), device=CPU)
    for key in mlp:
        assert torch.equal(layer["mlp"][key], mlp[key])
