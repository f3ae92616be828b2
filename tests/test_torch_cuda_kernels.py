"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device and skips without one; the
file imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest -m cuda tests/test_torch_cuda_kernels.py

Tolerances are chip_smoke.py's: distances within rtol 1e-5 and
atol 1e-4 * (||a||^2 + ||b||^2), also for batches of windows, for every
variant of pairwise_sqdist (stream, tiled, batched); labels
equal on every row whose two nearest distances differ by more than 1e-5
relative (the kernel's FMA order and cuBLAS's differ in the last bits);
sums within rtol 1e-5 / atol 1e-4, counts exactly, for both variants of
kmeans_assign (small, stream), each checked to be the one its plan
names; group-prox rows
within rtol 1e-6 / atol 1e-7 * ||v|| (the row norm summed in another
order); flash attention within rtol/atol 1e-4 in float32 (the CUDA-core
kernel) and, in bfloat16 (the tensor-core kernel), within one bf16 ulp
of the plain version (2^-7 |want|: both round an fp32 result whose two
summation orders differ by ~1e-6) plus 1e-4 max|v|; a repeat run
bit-identical.  The AMA's two passes: the fused step equals the plain
prox of PyTorch's gradient step bit for bit (its max |new - nu| too),
and the gather-back equals the CPU's segment sums bit for bit and lies
within 1e-6 of fp64's relative to the magnitudes added.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import group_prox as tprox
from repro_torch.kernels import kmeans_assign as tassign
from repro_torch.kernels import ops
from repro_torch.kernels import pairwise_l2 as tpairwise

pytestmark = pytest.mark.cuda

SHAPES = [(1, 1, 16), (1, 8, 64), (7, 8, 64), (4097, 257, 16),
          (4096, 8, 64), (4097, 8, 200), (65536, 8, 64)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _draw(seed, device, *shapes):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device)
            for s in shapes]


@pytest.mark.parametrize("m,k,d", SHAPES)
def test_pairwise_kernel_matches_plain(cuda_device, m, k, d):
    a, b = _draw(m + k + d, cuda_device, (m, d), (k, d))
    got = tpairwise.pairwise_sqdist(a, b)
    torch.cuda.synchronize()
    want = tpairwise.pairwise_sqdist_ref(a, b)
    scale = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :]
    excess = (got - want).abs() - (1e-5 * want.abs() + 1e-4 * scale)
    assert float(excess.max()) <= 0.0


@pytest.mark.parametrize("m,k,d", SHAPES)
def test_assign_kernel_matches_plain(cuda_device, m, k, d):
    pts, cts = _draw(3 * m + k + d, cuda_device, (m, d), (k, d))
    lab, sums, cnt = tassign.kmeans_assign(pts, cts)
    torch.cuda.synchronize()
    wl, ws, wc = tassign.kmeans_assign_ref(pts, cts)
    if k > 1:
        two = torch.topk(tpairwise.pairwise_sqdist_ref(pts, cts), 2, dim=1,
                         largest=False).values
        clear = (two[:, 1] - two[:, 0]) > 1e-5 * two[:, 1].abs()
    else:
        clear = torch.ones(m, dtype=torch.bool, device=cuda_device)
    assert torch.equal(lab[clear], wl[clear])
    if bool(clear.all()):
        torch.testing.assert_close(sums, ws, rtol=1e-5, atol=1e-4)
        assert torch.equal(cnt, wc)
    again = tassign.kmeans_assign(pts, cts)
    assert torch.equal(again[0], lab) and torch.equal(again[1], sums)
    assert torch.equal(again[2], cnt)


# each variant of the two redesigned kernels: single routes (m = 1, k = 1,
# k = 257), both sides of kmeans_assign's small-m threshold, the batch
# route, zero-padded d, rows that fill few tiles, and the Lloyd shape
VARIANT_SHAPES = [(1, 8, 64), (1, 8, 32), (1, 1, 16), (1, 257, 64),
                  (255, 8, 36), (256, 8, 64), (257, 8, 64), (4096, 8, 64),
                  (4097, 1, 64), (4097, 257, 16), (4097, 257, 200),
                  (4097, 8, 200), (5000, 3, 5), (1_048_576, 8, 64)]


def _blobs(seed, device, m, k, d):
    """Points near k centers, as Lloyd sees them."""
    a, b = _draw(seed, device, (m, d), (k, d))
    return b[torch.arange(m, device=device) % k] + 0.5 * a, b


def _clear_rows(pts, cts):
    if cts.shape[0] == 1:
        return torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
    two = torch.topk(tpairwise.pairwise_sqdist_ref(pts, cts), 2, dim=1,
                     largest=False).values
    return (two[:, 1] - two[:, 0]) > 1e-5 * two[:, 1].abs()


@pytest.mark.parametrize("m,k,d", VARIANT_SHAPES)
def test_assign_variants_match_plain_and_repeat_bit_for_bit(cuda_device, m,
                                                            k, d):
    pts, cts = _blobs(m + k + d, cuda_device, m, k, d)
    variant = tassign.assign_plan(m, k, d).variant
    before = dict(tassign.kmeans_assign.by_variant)
    lab, sums, cnt = tassign.kmeans_assign(pts, cts)
    torch.cuda.synchronize()
    wl, ws, wc = tassign.kmeans_assign_ref(pts, cts)
    clear = _clear_rows(pts, cts)
    assert torch.equal(lab[clear], wl[clear])
    # sums and counts of the labels the kernel chose
    ws = torch.nn.functional.one_hot(lab.long(), k).float().T @ pts
    wc = torch.bincount(lab.long(), minlength=k).float()
    assert torch.equal(cnt, wc)
    torch.testing.assert_close(sums, ws, rtol=1e-5, atol=1e-4)
    for _ in range(2):       # the streaming sums too: fixed order, no atomics
        again = tassign.kmeans_assign(pts, cts)
        assert all(torch.equal(x, y) for x, y in zip(again, (lab, sums, cnt)))
    after = tassign.kmeans_assign.by_variant
    assert {v: after[v] - before[v] for v in after} == {
        **dict.fromkeys(after, 0), variant: 3}


@pytest.mark.parametrize("m,k,d", VARIANT_SHAPES + [(7, 16, 4), (7, 17, 4),
                                                    (33, 8, 5)])
def test_pairwise_variants_match_plain_and_repeat_bit_for_bit(cuda_device, m,
                                                              k, d):
    a, b = _draw(2 * m + k + d, cuda_device, (m, d), (k, d))
    variant = tpairwise.pairwise_plan(m, k, d)[0]
    before = dict(tpairwise.pairwise_sqdist.by_variant)
    got = tpairwise.pairwise_sqdist(a, b)
    torch.cuda.synchronize()
    want = tpairwise.pairwise_sqdist_ref(a, b)
    scale = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :]
    assert float(((got - want).abs() - (1e-5 * want.abs() + 1e-4 * scale))
                 .max()) <= 0.0
    assert torch.equal(tpairwise.pairwise_sqdist(a, b), got)
    after = tpairwise.pairwise_sqdist.by_variant
    assert {v: after[v] - before[v] for v in after} == {
        **dict.fromkeys(after, 0), variant: 2}


# small feature dims: a row of d = 4, 8 or 12 floats fills 16 to 48 bytes
# of each 128-byte line of the TMA box (BOX_COLS = 32), the rest zero
# filled; the spectral seeding's farthest-point traversal runs at
# (m, 8) x (8, 8).  k = 5 with d = 5 goes to the tiled kernel.
SMALL_D = [(m, k, d) for d in (4, 8, 12) for k in (3, 5, 8)
           for m in (1, 7, 4097)] + [(1_048_576, 8, 8), (4097, 5, 5)]


@pytest.mark.parametrize("m,k,d", SMALL_D)
def test_pairwise_small_d_matches_plain_with_the_planned_variant(
        cuda_device, m, k, d):
    a, b = _draw(5 * m + 3 * k + d, cuda_device, (m, d), (k, d))
    variant = tpairwise.pairwise_plan(m, k, d)[0]
    assert variant == ("tiled" if d % 4 else "stream")
    before = dict(tpairwise.pairwise_sqdist.by_variant)
    got = tpairwise.pairwise_sqdist(a, b)
    torch.cuda.synchronize()
    want = tpairwise.pairwise_sqdist_ref(a, b)
    scale = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :]
    assert float(((got - want).abs() - (1e-5 * want.abs() + 1e-4 * scale))
                 .max()) <= 0.0
    assert torch.equal(tpairwise.pairwise_sqdist(a, b), got)
    after = tpairwise.pairwise_sqdist.by_variant
    assert {v: after[v] - before[v] for v in after} == {
        **dict.fromkeys(after, 0), variant: 2}


def test_streaming_variants_read_unaligned_rows(cuda_device):
    # rows 4 bytes off the TMA's 16-byte grid go through an aligned copy
    pts, cts = _blobs(3, cuda_device, 4097, 8, 64)
    flat = torch.cat([torch.zeros(1, device=cuda_device), pts.reshape(-1)])
    shifted = flat[1:].reshape(4097, 64)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    got = tassign.kmeans_assign(shifted, cts)
    want = tassign.kmeans_assign(pts, cts)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert torch.equal(tpairwise.pairwise_sqdist(shifted, cts),
                       tpairwise.pairwise_sqdist(pts, cts))


def test_a_single_route_is_one_small_launch(cuda_device):
    pts, cts = _blobs(4, cuda_device, 1, 8, 64)
    ops.reset_launch_counts()
    ops.kmeans_assign(pts, cts)
    assert ops.launch_counts()["kmeans_assign"] == 1
    assert ops.variant_counts()["kmeans_assign"] == {"small": 1, "stream": 0}


def test_launch_counters_count_kernel_launches(cuda_device):
    a, b = _draw(0, cuda_device, (33, 16), (4, 16))
    ops.reset_launch_counts()
    ops.pairwise_sqdist(a, b)
    ops.kmeans_assign(a, b)
    ops.kmeans_assign(a, b)
    ops.group_ball_proj(a, 0.5)
    ops.group_ball_proj_batched(a[None], 0.5)
    ops.group_ball_proj_batched(a[None, :0], 0.5)        # e = 0: no launch
    q = torch.randn((1, 4, 9, 16), device=cuda_device)
    ops.flash_attention(q, q[:, :2], q[:, :2])
    ops.flash_attention(q[:, :, :0], q, q)                # sq = 0: no launch
    assert ops.launch_counts() == {"pairwise_sqdist": 1, "kmeans_assign": 2,
                                   "group_ball_proj": 1,
                                   "group_ball_proj_batched": 1,
                                   "ama_gather_back": 0,
                                   "flash_attention": 1}
    # without the AMA step's operands the batched prox is the plain one
    assert ops.variant_counts()["group_ball_proj_batched"] == {
        "plain": 1, "ama_step": 0}


@pytest.mark.parametrize("nb,m,k,d", [(256, 64, 192, 32), (3, 7, 21, 5),
                                      (2, 300, 40, 200), (1, 1, 1, 1)])
def test_batched_pairwise_kernel_matches_plain(cuda_device, nb, m, k, d):
    a, b = _draw(nb + m + k + d, cuda_device, (nb, m, d), (nb, k, d))
    got = tpairwise.pairwise_sqdist(a, b)
    torch.cuda.synchronize()
    want = tpairwise.pairwise_sqdist_ref(a, b)
    scale = (a * a).sum(2)[:, :, None] + (b * b).sum(2)[:, None, :]
    excess = (got - want).abs() - (1e-5 * want.abs() + 1e-4 * scale)
    assert float(excess.max()) <= 0.0
    # each window equals the 2-D kernel on that window, bit for bit
    for z in (0, nb - 1):
        assert torch.equal(got[z], tpairwise.pairwise_sqdist(a[z], b[z]))


def _prox_rows(seed, device, b, e, d):
    """Rows of v with radii that put some rows inside the ball, some
    outside, some exactly on it, zero rows and inert (r = 0) slots."""
    v, r = _draw(seed, device, (b, e, d), (b, e))
    r = r.abs() * torch.sqrt((v * v).sum(-1))
    norms = torch.sqrt((v * v).sum(-1))
    r[:, ::5] = norms[:, ::5]                  # on the sphere
    r[:, 1::7] = 0.0                           # inert slots
    v[:, 2::11] = 0.0                          # zero rows
    return v, r


def _assert_prox_close(got, want, v):
    tol = 1e-6 * want.abs() + 1e-7 * torch.sqrt((v * v).sum(-1, keepdim=True))
    assert bool(((got - want).abs() <= tol).all())


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("e", [1, 7, 1031])
@pytest.mark.parametrize("d", [1, 16, 32, 200])
def test_group_prox_kernels_match_plain(cuda_device, b, e, d):
    v, r = _prox_rows(b * 10000 + e * 10 + d, cuda_device, b, e, d)
    got = tprox.group_ball_proj_batched(v, r)
    torch.cuda.synchronize()
    _assert_prox_close(got, tprox.group_ball_proj_batched_ref(v, r), v)
    assert torch.equal(tprox.group_ball_proj_batched(v, r), got)
    for radius in (r[0], 0.75):                # per row, scalar
        one = tprox.group_ball_proj(v[0], radius)
        torch.cuda.synchronize()
        _assert_prox_close(one, tprox.group_ball_proj_ref(v[0], radius), v[0])
    # a radius per rung, broadcast over the edges without a copy
    rung = torch.rand((b, 1), device=cuda_device)
    _assert_prox_close(tprox.group_ball_proj_batched(v, rung),
                       tprox.group_ball_proj_batched_ref(v, rung), v)


def test_cuda_tensors_never_reach_the_plain_prox(cuda_device, monkeypatch):
    def refuse(*_):
        raise AssertionError("plain version called with CUDA tensors")

    monkeypatch.setattr(tprox, "group_ball_proj_ref", refuse)
    monkeypatch.setattr(tprox, "group_ball_proj_batched_ref", refuse)
    v = torch.randn((2, 9, 32), device=cuda_device)
    assert ops.group_ball_proj(v[0], 0.5).is_cuda
    assert ops.group_ball_proj_batched(v, 0.5).is_cuda


def test_group_prox_edge_cases(cuda_device):
    ops.reset_launch_counts()
    empty = tprox.group_ball_proj_batched(
        torch.zeros((2, 0, 32), device=cuda_device),
        torch.zeros((2, 0), device=cuda_device))
    assert empty.shape == (2, 0, 32)
    assert tprox.group_ball_proj(torch.zeros((0, 8), device=cuda_device),
                                 1.0).shape == (0, 8)
    assert ops.launch_counts()["group_ball_proj_batched"] == 0
    assert ops.launch_counts()["group_ball_proj"] == 0
    # an unaligned view takes the scalar-load path
    v = torch.randn((65, 32), device=cuda_device)
    shifted = v.reshape(-1)[1:1 + 64 * 32].reshape(64, 32)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    got = tprox.group_ball_proj(shifted, 0.3)
    _assert_prox_close(got, tprox.group_ball_proj_ref(shifted, 0.3), shifted)
    with pytest.raises(TypeError):
        tprox.group_ball_proj(v.double(), 1.0)
    with pytest.raises(ValueError):
        tprox.group_ball_proj(v.T, 1.0)
    with pytest.raises(RuntimeError):
        tprox.group_ball_proj(v, torch.ones(3, device=cuda_device))


def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    a, b = _draw(2, cuda_device, (8, 4), (3, 4))
    with pytest.raises(TypeError):
        tpairwise.pairwise_sqdist(a.double(), b.double())
    with pytest.raises(ValueError):
        tassign.kmeans_assign(a.T, b)
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.zeros((1024, 64), device=cuda_device)
        tassign.kmeans_assign(big[:1], big)


def _attn_inputs(seed, device, b, hkv, rep, sq, skv, dh, dtype, strided):
    """q, k, v as the model hands them over (transposes of (b, s, h, dh))
    or contiguous (b, h, s, dh)."""
    h = hkv * rep
    shapes = [(b, sq, h, dh), (b, skv, hkv, dh), (b, skv, hkv, dh)]
    ts = _draw(seed, device, *shapes)
    if strided:
        return [t.to(dtype).transpose(1, 2) for t in ts]
    return [t.transpose(1, 2).contiguous().to(dtype) for t in ts]


def _assert_attn_close(got, want, v):
    assert got.dtype == want.dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        tol = 1e-4 + 1e-4 * want.abs()
    else:
        tol = 2.0 ** -7 * want.float().abs() + 1e-4 * float(v.abs().max())
    assert bool((err <= tol).all()), float(err.max())


# (b, hkv, rep, sq, skv, dh, window, causal): ragged tiles, kv offsets of
# 0, 1 and 60, sq > skv (rows without keys), every decoder head_dim
ATTN_CASES = [(1, 1, 1, 1, 1, 8, None, True), (2, 2, 7, 7, 8, 36, 5, True),
              (1, 2, 2, 129, 189, 64, 32, True),
              (2, 1, 7, 1000, 1000, 128, None, True),
              (1, 1, 2, 129, 130, 256, 32, False),
              (1, 2, 1, 8, 5, 64, None, True), (1, 1, 7, 70, 3, 36, 4, True),
              (3, 2, 2, 65, 125, 16, None, False),
              (1, 4, 2, 300, 300, 80, 5, False),
              (2, 1, 2, 129, 129, 80, None, True),
              (1, 2, 7, 200, 333, 192, 64, True),
              (1, 1, 2, 65, 65, 192, None, False),
              (1, 2, 7, 33, 40, 36, 16, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hkv,rep,sq,skv,dh,window,causal", ATTN_CASES)
def test_flash_kernel_matches_plain(cuda_device, dtype, b, hkv, rep, sq, skv,
                                    dh, window, causal):
    q, k, v = _attn_inputs(sq + skv + dh, cuda_device, b, hkv, rep, sq, skv,
                           dh, dtype, strided=(sq % 2 == 1))
    got = tflash.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = tflash.flash_attention_ref(q, k, v, causal=causal, window=window)
    _assert_attn_close(got, want, v)
    if causal and sq > skv:
        assert bool((got[:, :, :sq - skv] == 0).all())
    assert torch.equal(tflash.flash_attention(q, k, v, causal=causal,
                                              window=window), got)


def test_cuda_tensors_never_reach_the_plain_attention(cuda_device,
                                                      monkeypatch):
    def refuse(*_, **__):
        raise AssertionError("plain version called with CUDA tensors")

    monkeypatch.setattr(tflash, "flash_attention_ref", refuse)
    q, k, v = _attn_inputs(1, cuda_device, 1, 2, 7, 33, 33, 64,
                           torch.bfloat16, strided=True)
    out = ops.flash_attention(q, k, v, causal=True, window=16)
    assert out.is_cuda and out.dtype == torch.bfloat16


def test_bf16_attention_runs_only_on_the_tensor_cores(cuda_device,
                                                     monkeypatch):
    def refuse(*_, **__):
        raise AssertionError("plain version called with CUDA tensors")

    monkeypatch.setattr(tflash, "flash_attention_ref", refuse)
    cases = [(64, True), (36, True), (80, False), (256, True)]
    for dh, strided in cases:
        q, k, v = _attn_inputs(dh, cuda_device, 1, 2, 7, 70, 90, dh,
                               torch.bfloat16, strided=strided)
        before = tflash.kernel_launches()
        out = ops.flash_attention(q, k, v, causal=True, window=32)
        torch.cuda.synchronize()
        after = tflash.kernel_launches()
        assert out.shape == q.shape and out.dtype == torch.bfloat16
        assert after["tensor_core"] == before["tensor_core"] + 1
        assert after["cuda_core"] == before["cuda_core"]
    q, k, v = _attn_inputs(1, cuda_device, 1, 2, 7, 70, 90, 64,
                           torch.float32, strided=True)
    before = tflash.kernel_launches()
    ops.flash_attention(q, k, v, causal=True, window=32)
    after = tflash.kernel_launches()
    assert after["cuda_core"] == before["cuda_core"] + 1
    assert after["tensor_core"] == before["tensor_core"]


def test_flash_bf16_reads_misaligned_operands_through_a_padded_copy(
        cuda_device):
    # k and v 8 bytes off TMA's 16-byte grid: the wrapper copies all three
    q, _, _ = _attn_inputs(5, cuda_device, 1, 2, 2, 100, 100, 64,
                           torch.bfloat16, strided=True)
    wide = _draw(6, cuda_device, (1, 100, 2, 72), (1, 100, 2, 72))
    k, v = (t.bfloat16()[..., 4:68].transpose(1, 2) for t in wide)
    assert k.data_ptr() % 16 == 8
    got = tflash.flash_attention(q, k, v, causal=True, window=None)
    torch.cuda.synchronize()
    want = tflash.flash_attention_ref(q, k, v, causal=True, window=None)
    _assert_attn_close(got, want, v)


def test_flash_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    q = torch.randn((1, 2, 4, 320), device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        tflash.flash_attention(q, q, q)
    q = torch.randn((1, 2, 4, 8), device=cuda_device)
    with pytest.raises(TypeError):
        tflash.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(TypeError):
        tflash.flash_attention(q, q.bfloat16(), q.bfloat16())
    with pytest.raises(ValueError, match="window"):
        tflash.flash_attention(q, q, q, window=-1)


# the hierarchical round's shapes: one shard's Lloyd at C / 32 rows and
# the top level's over the 32 x 8 shard centers (the small-m threshold);
# the Section 5 federation's kmeans++ / host Lloyd (stream) and ODCL-CC
# fusion test (tiled)
HIERARCHY_SHAPES = [(32_768, 8, 64), (256, 8, 64)]
PAPER_SHAPES = [(100, 10, 20), (100, 100, 20)]
# the LM federation (C = 8 clients, K = 2, sketch 128): ODCL's kmeans++
# distances and device Lloyd, IFCA's sketch assignment and its first
# kmeans++ row
LM_SHAPES = [(8, 2, 128), (8, 1, 128)]


@pytest.mark.parametrize("m,k,d", HIERARCHY_SHAPES + PAPER_SHAPES
                         + LM_SHAPES)
def test_hierarchy_and_paper_shapes_match_plain_with_the_planned_variant(
        cuda_device, m, k, d):
    pts, cts = _blobs(7 * m + k + d, cuda_device, m, k, d)
    before = {"assign": dict(tassign.kmeans_assign.by_variant),
              "pairwise": dict(tpairwise.pairwise_sqdist.by_variant)}
    got = tpairwise.pairwise_sqdist(pts, cts)
    lab, sums, cnt = tassign.kmeans_assign(pts, cts)
    torch.cuda.synchronize()
    want = tpairwise.pairwise_sqdist_ref(pts, cts)
    scale = (pts * pts).sum(1)[:, None] + (cts * cts).sum(1)[None, :]
    assert float(((got - want).abs() - (1e-5 * want.abs() + 1e-4 * scale))
                 .max()) <= 0.0
    clear = _clear_rows(pts, cts)
    wl, _, _ = tassign.kmeans_assign_ref(pts, cts)
    assert torch.equal(lab[clear], wl[clear])
    ws = torch.nn.functional.one_hot(lab.long(), k).float().T @ pts
    assert torch.equal(cnt, torch.bincount(lab.long(), minlength=k).float())
    torch.testing.assert_close(sums, ws, rtol=1e-5, atol=1e-4)
    after = {"assign": tassign.kmeans_assign.by_variant,
             "pairwise": tpairwise.pairwise_sqdist.by_variant}
    planned = {"assign": tassign.assign_plan(m, k, d).variant,
               "pairwise": tpairwise.pairwise_plan(m, k, d)[0]}
    for name in after:
        assert {v: after[name][v] - before[name][v] for v in after[name]} == {
            **dict.fromkeys(after[name], 0), planned[name]: 1}
    if (m, k, d) == (256, 8, 64):
        assert planned["assign"] == "small"
    if (m, k, d) == (100, 100, 20):
        assert planned["pairwise"] == "tiled"


def test_group_prox_at_the_paper_host_ama_shape(cuda_device):
    """ODCL-CC's host AMA on the Section 5 federation: E = 4950 edges of
    d = 20, one scalar radius."""
    (v,) = _draw(4950, cuda_device, (4950, 20))
    got = tprox.group_ball_proj(v, 0.75)
    torch.cuda.synchronize()
    want = tprox.group_ball_proj_ref(v, 0.75)
    norm = torch.linalg.vector_norm(v, dim=1, keepdim=True)
    assert bool(((got - want).abs() <= 1e-6 * want.abs() + 1e-7 * norm).all())
    assert torch.equal(tprox.group_ball_proj(v, 0.75), got)


# ------------------------------------------- the AMA iteration's passes

AMA_D = [3, 20, 32, 64, 128]


def _ama_edges(kind, m, device, seed=0):
    """(i_idx, j_idx) int64 on the device: the complete graph (sorted
    heads), or random pairs over the first m - 5 nodes (unsorted heads,
    a ragged E, nodes in no edge)."""
    if kind == "complete":
        i, j = torch.triu_indices(m, m, 1)
        return i.to(device), j.to(device)
    rng = np.random.default_rng(seed)
    i = rng.integers(0, m - 5, size=11 * m + 3)
    j = rng.integers(0, m - 5, size=11 * m + 3)
    keep = i != j
    return (torch.from_numpy(np.minimum(i, j)[keep]).to(device),
            torch.from_numpy(np.maximum(i, j)[keep]).to(device))


def _ama_radius(layout, b, e, device, seed):
    (r,) = _draw(seed, device, (b, e))
    r = r.abs() * 3.0
    r[:, 1::7] = 0.0                                     # inert slots
    return {"scalar": 1.5, "rung": r[:, :1], "edge": r}[layout]


@pytest.mark.parametrize("d", AMA_D)
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("layout", ["scalar", "rung", "edge"])
def test_ama_step_is_the_plain_prox_of_the_old_composition(cuda_device, d, b,
                                                           layout):
    """The fused edge pass equals the plain kernel fed PyTorch's gradient
    step bit for bit, and its max |new - nu| is PyTorch's."""
    m = 97
    i_idx, j_idx = _ama_edges("random", m, cuda_device, seed=d)
    e = i_idx.numel()
    nu, u = _draw(d * 10 + b, cuda_device, (b, e, d), (b, m, d))
    radius = _ama_radius(layout, b, e, cuda_device, seed=d + b)
    eta = torch.tensor(1.0 / (2 * m), dtype=torch.float32,
                       device=cuda_device)
    ops.reset_launch_counts()
    want = tprox.group_ball_proj_batched(
        nu - eta * (u[:, i_idx] - u[:, j_idx]), radius)
    # in place, as the AMA loop runs it, twice from the same dual
    moved, again = (torch.full((), -1.0, device=cuda_device)
                    for _ in range(2))
    got, twice = nu.clone(), nu.clone()
    for dual, into in ((got, moved), (twice, again)):
        assert tprox.group_ball_proj_batched(
            dual, radius, u=u, i_idx=i_idx.to(torch.int32),
            j_idx=j_idx.to(torch.int32), eta=eta, moved=into) is dual
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(twice, want)
    assert torch.equal(moved, torch.max(torch.abs(want - nu)))
    assert torch.equal(again, moved)
    assert ops.variant_counts()["group_ball_proj_batched"] == {
        "plain": 1, "ama_step": 2}


def test_ama_step_refuses_what_it_cannot_take(cuda_device):
    nu, u = _draw(5, cuda_device, (1, 6, 4), (1, 4, 4))
    i_idx = torch.tensor([0, 0, 0, 1, 1, 2], dtype=torch.int32,
                         device=cuda_device)
    j_idx = torch.tensor([1, 2, 3, 2, 3, 3], dtype=torch.int32,
                         device=cuda_device)
    eta = torch.tensor(0.1, device=cuda_device)
    step = dict(u=u, i_idx=i_idx, j_idx=j_idx, eta=eta,
                moved=torch.zeros((), device=cuda_device))
    tprox.group_ball_proj_batched(nu, 1.0, **step)
    with pytest.raises(ValueError, match="missing"):
        tprox.group_ball_proj_batched(nu, 1.0, u=u)
    # the dual is stepped in place: a strided view cannot be
    with pytest.raises(ValueError, match="contiguous"):
        tprox.group_ball_proj_batched(nu.transpose(1, 2).contiguous()
                                      .transpose(1, 2), 1.0, **step)
    with pytest.raises(ValueError, match="does not fit"):
        tprox.group_ball_proj_batched(nu, 1.0, **{**step, "u": u[:, :, :3]
                                                  .contiguous()})
    with pytest.raises(ValueError, match="int32"):
        tprox.group_ball_proj_batched(nu, 1.0,
                                      **{**step, "i_idx": i_idx.long()})
    with pytest.raises(ValueError, match="eta"):
        tprox.group_ball_proj_batched(nu, 1.0, **{**step, "eta": eta.cpu()})


@pytest.mark.parametrize("d", AMA_D)
@pytest.mark.parametrize("kind,m", [("complete", 300), ("random", 97)])
def test_ama_gather_back_is_the_plain_segment_sums_bit_for_bit(cuda_device,
                                                               d, kind, m):
    """u = a + head sums - tail sums: two runs bit-identical, the CPU's
    plain version (segment_reduce, which adds a run in order) bit for bit,
    and within 1e-6 of the fp64 sums relative to the sum of the magnitudes
    added."""
    from repro_torch.core.engine.segment import segment_plan

    i_idx, j_idx = _ama_edges(kind, m, cuda_device, seed=d)
    e, b = i_idx.numel(), 2
    a, nu = _draw(d + m, cuda_device, (m, d), (b, e, d))
    heads, tails = segment_plan(i_idx, m), segment_plan(j_idx, m)
    assert (heads.order is None) == (kind == "complete")
    ops.reset_launch_counts()
    got, again = (torch.full((b, m, d), float("nan"), device=cuda_device)
                  for _ in range(2))
    assert tprox.ama_gather_back(a, nu, heads, tails, got) is got
    tprox.ama_gather_back(a, nu, heads, tails, again)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert ops.launch_counts()["ama_gather_back"] == 2
    cpu = tprox.ama_gather_back_ref(a.cpu(), nu.cpu(),
                                    segment_plan(i_idx.cpu(), m),
                                    segment_plan(j_idx.cpu(), m),
                                    torch.empty((b, m, d)))
    assert torch.equal(got.cpu(), cpu)

    def sums(heads_sign, tails_sign):
        out = torch.zeros((b, m, d), dtype=torch.float64, device=cuda_device)
        out.index_add_(1, i_idx, heads_sign)
        return out.index_add_(1, j_idx, tails_sign)

    nu64 = nu.double()
    want = a.double()[None] + sums(nu64, -nu64)
    scale = a.double().abs()[None] + sums(nu64.abs(), nu64.abs())
    assert bool(((got.double() - want).abs() <= 1e-6 * scale).all())


def test_ama_loop_launches_one_fused_step_and_one_gather_back_an_iteration(
        cuda_device):
    from repro_torch.core.engine import device_convex as tdc

    (pts,) = _draw(9, cuda_device, (64, 8))
    # one lambda, and the ladder's ten rungs in one batched solve
    for solve, kw in ((tdc.device_convex_cluster, {"lam": 0.05}),
                      (tdc.device_clusterpath, {"n_lambdas": 10})):
        ops.reset_launch_counts()
        res = solve(None, pts, iters=7, tol=0.0, **kw)
        assert res.n_iter == 7
        assert ops.variant_counts()["group_ball_proj_batched"] == {
            "plain": 0, "ama_step": 7}
        assert ops.launch_counts()["ama_gather_back"] == 8


def test_training_launches_no_flash_and_the_prefill_does(cuda_device):
    """A local training step (differentiable attention) launches no flash
    kernel on the card, its backward included; serving's prefill of the
    trained model launches one a layer."""
    from repro_torch.configs import get_config
    from repro_torch.core.federated import init_federation
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import client_slice, make_local_train_step
    from repro_torch.models.transformer import model_view

    cfg = get_config("qwen2-0.5b").reduced(n_layers=2, max_d_model=64,
                                           max_vocab=64)
    state = init_federation(0, cfg, 2, device=cuda_device)
    toks = torch.randint(0, 64, (2, 2, 17), device=cuda_device)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    ops.reset_launch_counts()
    losses, _, _ = make_local_train_step(cfg, remat="full")(
        state.params, state.opt_state, batch)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(losses).all())
    assert ops.launch_counts()["flash_attention"] == 0
    generate(model_view(client_slice(state.params, 0), cfg), cfg,
             toks[0, :, :8], 2, device=cuda_device)
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers


# the flash kernel at the new families' full-width prefill shapes, bf16:
# (b, hkv, rep, s, dh, window, causal) of deepseek-moe-16b (window 4096),
# hymba-1.5b (window 1024), pixtral-12b (window 4096 at s = 4096) and the
# hubert-xlarge encoder (non-causal); batch row 0 against the plain version
FAMILY_ATTN = {"deepseek-moe-16b": (4, 16, 1, 8192, 128, 4096, True),
               "hymba-1.5b": (4, 5, 5, 8192, 64, 1024, True),
               "pixtral-12b": (1, 8, 4, 4096, 128, 4096, True),
               "hubert-xlarge": (4, 16, 1, 4096, 80, None, False)}


@pytest.mark.parametrize("arch", sorted(FAMILY_ATTN))
def test_flash_kernel_at_the_family_shapes(cuda_device, arch):
    b, hkv, rep, s, dh, window, causal = FAMILY_ATTN[arch]
    q, k, v = _attn_inputs(s + dh, cuda_device, b, hkv, rep, s, s, dh,
                           torch.bfloat16, strided=True)
    got = tflash.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = tflash.flash_attention_ref(q[:1], k[:1], v[:1], causal=causal,
                                      window=window)
    _assert_attn_close(got[:1], want, v)
    assert torch.equal(tflash.flash_attention(q, k, v, causal=causal,
                                              window=window), got)


@pytest.mark.parametrize("arch,flash_per_prefill",
                         [("deepseek-moe-16b", 2), ("hymba-1.5b", 2),
                          ("xlstm-125m", 0), ("pixtral-12b", 2)])
def test_family_prefill_launches_flash_once_a_layer(cuda_device, arch,
                                                    flash_per_prefill):
    """A prefill of each new family on the card runs the flash kernel
    once an attention layer (the xLSTM none) and gives finite logits."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.transformer import PATCH_DIM, prefill_with_cache

    cfg = get_config(arch).reduced(max_d_model=128, max_vocab=64)
    model = init_params(cfg, device=cuda_device)
    batch = {"tokens": torch.randint(0, 64, (2, 32), device=cuda_device)}
    if cfg.input_mode == "multimodal":
        batch["patch_embeds"] = torch.randn((2, 4, PATCH_DIM),
                                            device=cuda_device)
        batch["patch_positions"] = torch.arange(
            4, device=cuda_device).expand(2, 4)
    ops.reset_launch_counts()
    with torch.inference_mode():
        logits, cache = prefill_with_cache(model, cfg, batch)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == flash_per_prefill
    assert bool(torch.isfinite(logits.float()).all())
    assert cache.pos == 32
