"""The port's flash attention (plain version and ``ops`` dispatch on the
CPU) against the reference's Pallas kernel in interpret mode and its jnp
oracle, on the same numpy inputs.

Tolerances: rtol/atol 1e-4 in float32, as the reference holds its Pallas
kernel to ``ref.flash_attention`` (``tests/test_kernels.py``).  Rows with
no live key (sq > skv under a causal mask) are zeros in the Pallas kernel
and in the port; ``ref.flash_attention`` gives the mean of v there, so it
is compared only where skv >= sq.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops

# (b, hkv, rep, sq, extra_kv, dh, window, causal): the reference test's
# grid (tests/test_kernels.py), b in 1..3, hkv in {1,2,4}, rep in {1,2,7},
# sq in 1..80, skv - sq in 0..60, dh in {8,16,64}, window in
# {None,5,32}, both masks
CASES = [
    (1, 1, 1, 1, 0, 8, None, True),
    (2, 2, 7, 17, 3, 16, 5, True),
    (3, 4, 2, 80, 60, 64, 32, False),
    (1, 2, 7, 33, 0, 64, None, False),
    (2, 1, 2, 64, 1, 8, 32, True),
    (1, 4, 1, 65, 17, 16, None, True),
    (3, 1, 7, 5, 60, 64, 5, False),
    (2, 2, 1, 80, 0, 16, 5, True),
]


def _inputs(b, hkv, rep, sq, skv, dh, seed):
    rng = np.random.default_rng(seed)
    h = hkv * rep
    q = rng.normal(size=(b, h, sq, dh)).astype(np.float32)
    k = rng.normal(size=(b, hkv, skv, dh)).astype(np.float32)
    v = rng.normal(size=(b, hkv, skv, dh)).astype(np.float32)
    return q, k, v


def _port(q, k, v, **kw):
    return tflash.flash_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        **kw).numpy()


@pytest.mark.parametrize("b,hkv,rep,sq,extra,dh,window,causal", CASES)
def test_plain_version_matches_pallas_and_ref(b, hkv, rep, sq, extra, dh,
                                              window, causal):
    q, k, v = _inputs(b, hkv, rep, sq, sq + extra, dh, b + rep + sq + dh)
    got = _port(q, k, v, causal=causal, window=window)
    pallas = np.asarray(flash_attention_pallas(
        q, k, v, causal=causal, window=window, interpret=True))
    want = np.asarray(ref.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window))
    np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("sq,skv,window", [(8, 5, None), (20, 3, 4)])
def test_rows_without_keys_are_zero_as_in_pallas(sq, skv, window):
    q, k, v = _inputs(1, 1, 2, sq, skv, 16, sq + skv)
    got = _port(q, k, v, causal=True, window=window)
    pallas = np.asarray(flash_attention_pallas(
        q, k, v, causal=True, window=window, interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=1e-4)
    # query i sits at i + skv - sq: the first sq - skv rows see no key
    assert np.all(got[:, :, :sq - skv] == 0.0)
    assert np.abs(got[:, :, sq - skv:]).max() > 0.0


def test_large_block_shapes_match_pallas():
    q, k, v = _inputs(1, 2, 1, 256, 384, 64, 0)
    got = _port(q, k, v, causal=True)
    pallas = np.asarray(flash_attention_pallas(q, k, v, causal=True,
                                               interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=1e-4)


def test_ops_dispatches_a_cpu_tensor_to_the_plain_version(monkeypatch):
    q, k, v = _inputs(2, 2, 7, 9, 11, 36, 3)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    calls = []
    plain = tflash.flash_attention_ref

    def spy(*args, **kw):
        calls.append(kw)
        return plain(*args, **kw)

    monkeypatch.setattr(tflash, "flash_attention_ref", spy)
    before = tflash.flash_attention.launches
    out = ops.flash_attention(tq, tk, tv, causal=True, window=4)
    assert calls == [{"causal": True, "window": 4}]
    assert tflash.flash_attention.launches == before
    assert out.dtype == torch.float32 and out.shape == (2, 14, 9, 36)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(flash_attention_pallas(
            q, k, v, causal=True, window=4, interpret=True)),
        rtol=1e-4, atol=1e-4)


def test_plain_version_keeps_bfloat16_and_reads_strided_inputs():
    q, k, v = _inputs(1, 2, 7, 12, 12, 36, 5)
    # the model hands over transposes of (b, s, h, dh)
    tq, tk, tv = (torch.from_numpy(a).transpose(1, 2).contiguous()
                  .transpose(1, 2) for a in (q, k, v))
    assert not tq.is_contiguous()
    out = tflash.flash_attention_ref(tq.bfloat16(), tk.bfloat16(),
                                     tv.bfloat16(), causal=True)
    assert out.dtype == torch.bfloat16
    want = _port(q, k, v, causal=True)
    # bf16 inputs: a relative error of a few 2^-8 on O(1) values
    np.testing.assert_allclose(out.float().numpy(), want, rtol=0, atol=5e-2)


def test_kernel_wrapper_refuses_what_it_does_not_take():
    q = torch.zeros((1, 2, 4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="k/v"):
        ops.flash_attention(q, torch.zeros((1, 3, 4, 8)),
                            torch.zeros((1, 3, 4, 8)))
