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
from repro_torch import runtime
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One host thread: the tensors here are small, and parallel test
    workers must not oversubscribe the CPU."""
    with runtime.pinned_threads(1):
        yield


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


# ---------------------------------------------------------------------------
# The bf16 tensor-core kernel's arithmetic, emulated on the CPU: bf16 q . k
# products summed in fp32, the online softmax in the log2 domain over key
# tiles of BK (128 for dh <= 128, 64 above, as the kernel picks), and
# O += P_hi V + P_lo V with P_hi = bf16(P), P_lo = bf16(P - P_hi).  Inputs
# are bf16 values held in fp32, so the reference and the Pallas kernel see
# the same numbers; tolerance rtol/atol 1e-5 (the split leaves at most
# 2^-16 P behind, the rest is summation order).

LOG2E = 1.4426950408889634


def _emulate_tensor_core(q, k, v, *, causal, window, scale):
    b, h, sq, dh = q.shape
    _, hkv, skv, _ = k.shape
    bk = 128 if dh <= 128 else 64
    kf = k.repeat_interleave(h // hkv, dim=1)
    vf = v.repeat_interleave(h // hkv, dim=1)
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    m = torch.full((b, h, sq), -torch.inf)
    l = torch.zeros((b, h, sq))
    o = torch.zeros((b, h, sq, dh))
    qpos = torch.arange(sq)[:, None] + (skv - sq)
    for kt in range(0, skv, bk):
        kpos = torch.arange(kt, min(kt + bk, skv))[None, :]
        live = torch.ones((sq, kpos.shape[1]), dtype=torch.bool)
        if causal:
            live &= kpos <= qpos
        if window is not None:
            live &= kpos > qpos - window
        s = torch.matmul(q, kf[:, :, kt:kt + bk].transpose(-1, -2))
        s = s.masked_fill(~live, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1) * c)
        mu = torch.where(m_new == -torch.inf, 0.0, m_new)
        alpha = torch.exp2(m - mu)
        p = torch.exp2(s * c - mu[..., None])
        l = l * alpha + p.sum(-1)
        p_hi = p.bfloat16().float()
        p_lo = (p - p_hi).bfloat16().float()
        vt = vf[:, :, kt:kt + bk]
        o = o * alpha[..., None] + torch.matmul(p_hi, vt) + torch.matmul(
            p_lo, vt)
        m = m_new
    return o / torch.clamp_min(l, 1e-30)[..., None]


def _bf16_values(*arrays):
    return [torch.from_numpy(a).bfloat16().float().numpy() for a in arrays]


@pytest.mark.parametrize("dh", [64, 80, 128, 192, 256])
def test_tensor_core_arithmetic_matches_ref_and_pallas(dh):
    q, k, v = _bf16_values(*_inputs(1, 2, 2, 40, 200, dh, dh))
    got = _emulate_tensor_core(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal=True, window=48,
                               scale=1.0 / np.sqrt(dh)).numpy()
    want = _port(q, k, v, causal=True, window=48)
    pallas = np.asarray(flash_attention_pallas(q, k, v, causal=True,
                                               window=48, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)


def test_tensor_core_arithmetic_on_padded_head_dim_and_keyless_rows():
    # dh = 36 runs as a zero-padded 48 with the scale of 36; sq > skv
    # leaves the first rows without a key under the causal mask
    q, k, v = _bf16_values(*_inputs(1, 1, 7, 70, 67, 36, 11))
    tq, tk, tv = tflash.tensor_core_operands(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)))
    assert tq.shape[-1] == 48
    got = _emulate_tensor_core(tq.float(), tk.float(), tv.float(),
                               causal=True, window=None,
                               scale=1.0 / np.sqrt(36))[..., :36].numpy()
    want = _port(q, k, v, causal=True)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.all(got[:, :, :3] == 0.0)


def test_split_p_keeps_fp32_accuracy():
    rng = np.random.default_rng(0)
    p = torch.from_numpy(np.exp(-rng.uniform(0.0, 30.0, size=1 << 20))
                         .astype(np.float32))
    p_hi = p.bfloat16().float()
    p_lo = (p - p_hi).bfloat16().float()
    alone = (p - p_hi).abs() / p
    split = (p - p_hi - p_lo).abs() / p
    assert float(alone.max()) <= 2.0 ** -8
    assert float(split.max()) <= 2.0 ** -15
    # the bf16 rounding of P alone is visible; the split's is not
    assert float(alone.max()) > 2.0 ** -10 > 2.0 ** -16 > float(split.max())


def test_tensor_core_operands_pad_only_what_tma_cannot_read():
    def bshd(b, s, n, width, lo, hi):
        base = torch.arange(b * s * n * width, dtype=torch.float32)
        return base.reshape(b, s, n, width).bfloat16()[..., lo:hi] \
            .transpose(1, 2)

    # the model's transposed views at dh = 64: read in place
    q, k, v = bshd(2, 9, 14, 64, 0, 64), bshd(2, 9, 2, 64, 0, 64), \
        bshd(2, 9, 2, 64, 0, 64)
    out = tflash.tensor_core_operands(q, k, v)
    assert all(a is b for a, b in zip(out, (q, k, v)))
    # a 16-byte aligned window of a wider row is read in place too
    k8 = bshd(2, 9, 2, 72, 8, 72)
    assert tflash.tensor_core_operands(q, k8, v)[1] is k8
    # a base 8 bytes off the 16-byte grid: all three are copied
    k4 = bshd(2, 9, 2, 72, 4, 68)
    for a, b in zip(tflash.tensor_core_operands(q, k4, v), (q, k4, v)):
        assert a is not b and a.shape == b.shape
        assert a.transpose(1, 2).is_contiguous() and torch.equal(a, b)
    # dh = 36: zero-padded to 48, each a view of a contiguous (b,s,n,48)
    q36, k36 = bshd(1, 5, 7, 36, 0, 36), bshd(1, 5, 1, 36, 0, 36)
    pq, pk, pv = tflash.tensor_core_operands(q36, k36, k36)
    assert pq.shape == (1, 7, 5, 48) and pk.shape == pv.shape == (1, 1, 5, 48)
    assert pq.transpose(1, 2).is_contiguous()
    assert torch.equal(pq[..., :36], q36) and torch.equal(pk[..., :36], k36)
    assert not pq[..., 36:].any() and not pv[..., 36:].any()
