"""The port's kernel modules against the JAX reference's kernels.

On the CPU the port's ``kernels.ops`` runs each kernel's plain PyTorch
version; it is held to the reference's jnp oracle (``repro.kernels.ref``)
and to the Pallas kernel run in interpret mode, on the same numpy
inputs.  Tolerance: rtol 1e-5 / atol 1e-4 on floats (fp32 sums taken in
another order), labels exactly.  The CUDA kernels themselves are held to
the plain versions in ``test_torch_cuda_kernels.py`` (which skips
without a card) and by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.kmeans_assign import kmeans_assign_pallas
from repro.kernels.pairwise_l2 import pairwise_sqdist_pallas
from repro_torch import runtime
from repro_torch.kernels import kmeans_assign as tassign
from repro_torch.kernels import ops
from repro_torch.kernels import pairwise_l2 as tpairwise


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One host thread: the tensors here are small, and parallel test
    workers must not oversubscribe the CPU."""
    with runtime.pinned_threads(1):
        yield


RTOL, ATOL = 1e-5, 1e-4

PAIRWISE_SHAPES = [(1, 1, 1), (1, 8, 64), (7, 3, 5), (64, 1, 16),
                   (129, 17, 130), (200, 40, 300), (513, 8, 64)]
ASSIGN_SHAPES = [(1, 1, 3), (1, 4, 8), (2, 1, 2), (37, 5, 9),
                 (150, 16, 100), (257, 8, 64), (1000, 8, 64)]


def _draw(seed, *shapes, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(dtype) for s in shapes]


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
@pytest.mark.parametrize("m,k,d", PAIRWISE_SHAPES)
def test_pairwise_sqdist_plain_matches_reference(m, k, d, dtype):
    a, b = _draw(m * 1000 + k * 10 + d, (m, d), (k, d), dtype=dtype)
    got = ops.pairwise_sqdist(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, k)
    want = np.asarray(jref.pairwise_sqdist(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    pallas = np.asarray(pairwise_sqdist_pallas(jnp.asarray(a), jnp.asarray(b),
                                               interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=RTOL, atol=ATOL)


def test_pairwise_sqdist_clamps_at_zero():
    a = np.full((3, 4), 1e3, np.float32)
    got = ops.pairwise_sqdist(torch.from_numpy(a), torch.from_numpy(a))
    assert (got.numpy() >= 0).all()
    want = np.asarray(jref.pairwise_sqdist(jnp.asarray(a), jnp.asarray(a)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m,k,d", ASSIGN_SHAPES)
def test_kmeans_assign_plain_matches_reference(m, k, d):
    pts, cts = _draw(m + 31 * k + 7 * d, (m, d), (k, d))
    lab, sums, cnt = ops.kmeans_assign(torch.from_numpy(pts),
                                       torch.from_numpy(cts))
    assert lab.dtype == torch.int32 and sums.dtype == torch.float32
    assert cnt.dtype == torch.float32
    for want in (jref.kmeans_assign(jnp.asarray(pts), jnp.asarray(cts)),
                 kmeans_assign_pallas(jnp.asarray(pts), jnp.asarray(cts),
                                      interpret=True)):
        wl, ws, wc = (np.asarray(x) for x in want)
        np.testing.assert_array_equal(lab.numpy(), wl)
        np.testing.assert_allclose(sums.numpy(), ws, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(cnt.numpy(), wc)


def test_kmeans_assign_ties_go_to_the_lowest_index():
    pts = np.zeros((5, 4), np.float32)
    cts = np.stack([np.ones(4), -np.ones(4), np.ones(4)]).astype(np.float32)
    lab, _, cnt = ops.kmeans_assign(torch.from_numpy(pts),
                                    torch.from_numpy(cts))
    want = np.asarray(jref.kmeans_assign(jnp.asarray(pts),
                                         jnp.asarray(cts))[0])
    np.testing.assert_array_equal(lab.numpy(), want)
    assert (lab.numpy() == 0).all() and cnt.tolist() == [5.0, 0.0, 0.0]


def test_cpu_dispatch_launches_no_kernel():
    ops.reset_launch_counts()
    a, b = _draw(0, (9, 4), (3, 4))
    ops.pairwise_sqdist(torch.from_numpy(a), torch.from_numpy(b))
    ops.kmeans_assign(torch.from_numpy(a), torch.from_numpy(b))
    q = torch.from_numpy(a).reshape(1, 1, 9, 4)
    ops.flash_attention(q, q, q)
    assert ops.launch_counts() == {"pairwise_sqdist": 0, "kmeans_assign": 0,
                                   "group_ball_proj": 0,
                                   "group_ball_proj_batched": 0,
                                   "ama_gather_back": 0,
                                   "flash_attention": 0}


@pytest.mark.parametrize("wrapper", [tpairwise.pairwise_sqdist,
                                     tassign.kmeans_assign])
def test_kernel_wrappers_refuse_cpu_tensors(wrapper):
    a = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="CUDA kernel"):
        wrapper(a, a)


def test_ops_refuses_other_devices():
    a = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.pairwise_sqdist(a, a)
    with pytest.raises(ValueError, match="no kernel"):
        ops.kmeans_assign(a, a)


# the route server's flush buckets: (n, 64) routes against (8, 64) centers
@pytest.mark.parametrize("n", [1, 2, 4, 8, 16, 32, 64])
def test_flush_buckets_plain_matches_reference_and_plan_small(n):
    pts, cts = _draw(900 + n, (n, 64), (8, 64))
    pts = cts[np.arange(n) % 8] + 0.5 * pts
    lab, sums, cnt = ops.kmeans_assign(torch.from_numpy(pts),
                                       torch.from_numpy(cts))
    wl, ws, wc = (np.asarray(x) for x in kmeans_assign_pallas(
        jnp.asarray(pts), jnp.asarray(cts), interpret=True))
    np.testing.assert_array_equal(lab.numpy(), wl)
    np.testing.assert_allclose(sums.numpy(), ws, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(cnt.numpy(), wc)
    assert tassign.assign_plan(n, 8, 64).variant == "small"


def test_launch_counters_are_exact_across_threads():
    """N threads x M counted launches (the wrappers' own counting step,
    which runs on the card after each launch) lose no count."""
    import sys
    import threading

    from repro_torch.kernels._counts import count_launch

    n_threads, m_calls = 8, 2000
    ops.reset_launch_counts()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)       # switch threads as often as possible
    try:
        def work(tid):
            for i in range(m_calls):
                count_launch(tassign.kmeans_assign,
                             "small" if i % 2 else "stream")
                count_launch(tpairwise.pairwise_sqdist, "tiled")
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    total = n_threads * m_calls
    assert ops.launch_counts()["kmeans_assign"] == total
    assert ops.launch_counts()["pairwise_sqdist"] == total
    assert ops.variant_counts()["kmeans_assign"] == {"small": total // 2,
                                                     "stream": total // 2}
    assert ops.variant_counts()["pairwise_sqdist"]["tiled"] == total
    ops.reset_launch_counts()
    assert ops.launch_counts()["kmeans_assign"] == 0
    assert ops.variant_counts()["kmeans_assign"] == {"small": 0,
                                                     "stream": 0}
