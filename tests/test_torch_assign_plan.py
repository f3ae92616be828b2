"""The variant choice of the port's two redesigned kernel wrappers.

``kmeans_assign.assign_plan`` and ``pairwise_l2.pairwise_plan`` pick a
kernel and its launch plan from the shapes alone; these tests hold them
at the edges of their thresholds on the CPU (the kernels themselves run
only on the card: ``test_torch_cuda_kernels.py``).  The plain versions
at the threshold shapes are held to the JAX reference's jnp oracle with
``test_torch_kernels.py``'s tolerances: rtol 1e-5 / atol 1e-4 on floats
(fp32 sums taken in another order), labels exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch import runtime
from repro_torch.kernels import _rowstream, ops
from repro_torch.kernels import kmeans_assign as tassign
from repro_torch.kernels import pairwise_l2 as tpairwise


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One host thread: the tensors here are small, and parallel test
    workers must not oversubscribe the CPU."""
    with runtime.pinned_threads(1):
        yield


SMALL = tassign.SMALL_M


@pytest.mark.parametrize("m,variant", [(1, "small"), (SMALL - 1, "small"),
                                       (SMALL, "small"), (SMALL + 1, "stream"),
                                       (4096, "stream"), (1_048_576, "stream")])
def test_assign_variant_turns_at_the_small_m_threshold(m, variant):
    assert tassign.assign_plan(m, 8, 64).variant == variant


@pytest.mark.parametrize("m,k,d", [(1, 8, 64), (1, 8, 32), (4096, 8, 64),
                                   (1_048_576, 8, 64), (4097, 257, 200),
                                   (5000, 3, 5), (SMALL, 257, 200),
                                   (SMALL + 1, 1, 1)])
def test_assign_plan_is_a_pure_function_that_fits(m, k, d):
    plan = tassign.assign_plan(m, k, d)
    tassign.assign_plan.cache_clear()
    assert tassign.assign_plan(m, k, d) == plan
    assert plan.smem_bytes <= _rowstream.SMEM_PER_BLOCK
    if plan.variant == "small":
        assert m <= SMALL and plan.d_pad == d and plan.rows == 0
    else:
        # whole 16-byte chunks for the TMA, tiles of whole swizzle atoms
        assert plan.d_pad % 4 == 0 and d <= plan.d_pad < d + 4
        assert plan.rows % 8 == 0 and 8 <= plan.rows <= _rowstream.MAX_ROWS
        assert 1 <= plan.stages <= _rowstream.MAX_STAGES


def test_assign_main_shapes_take_full_tiles_and_a_deep_ring():
    for d in (32, 64):
        plan = tassign.assign_plan(1_048_576, 8, d)
        assert (plan.rows, plan.smem_part) == (_rowstream.MAX_ROWS, True)
        assert plan.stages >= 3


def test_assign_small_variant_gives_way_when_the_rows_do_not_fit():
    # 256 rows of d = 200 beside 257 centers exceed a block's shared memory
    assert tassign.assign_plan(7, 257, 200).variant == "small"
    assert tassign.assign_plan(SMALL, 257, 200).variant == "stream"


def test_assign_plan_refuses_centers_that_fill_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        tassign.assign_plan(1, 1024, 64)
    with pytest.raises(ValueError, match="shared memory"):
        tassign.assign_plan(1_048_576, 1024, 64)


@pytest.mark.parametrize("m,k,d,variant", [
    (1_048_576, 8, 64, "stream"), (1, 1, 16, "stream"), (5, 16, 4, "stream"),
    (5, 17, 4, "tiled"), (4097, 8, 200, "stream"), (7, 8, 5, "tiled"),
    (1024, 16_384, 32, "tiled"), (4096, 4096, 32, "tiled"),
    (1, 257, 64, "tiled"),
    # spectral seeding's traversal, and the small feature dims around it
    (1_048_576, 8, 8, "stream"), (4097, 3, 4, "stream"),
    (4097, 5, 8, "stream"), (7, 8, 12, "stream"), (4097, 5, 5, "tiled")])
def test_pairwise_variant_follows_k_and_d(m, k, d, variant):
    name, rows, stages = tpairwise.pairwise_plan(m, k, d)
    assert name == variant
    if name == "stream":
        assert rows % 8 == 0 and 1 <= stages <= _rowstream.MAX_STAGES
        assert (tpairwise._stream_bytes(k, d, rows, stages)
                <= _rowstream.SMEM_PER_BLOCK)
    else:
        assert (rows, stages) == (0, 0)


def test_ring_plan_prefers_full_tiles_then_fewer_rows():
    full = _rowstream.ring_plan(lambda r, s: r * s * 128)
    assert full == (_rowstream.MAX_ROWS, _rowstream.MAX_STAGES)
    tight = _rowstream.ring_plan(lambda r, s: 200_000 + r * s * 256)
    assert tight[0] % 8 == 0 and tight[0] < _rowstream.MAX_ROWS
    assert _rowstream.ring_plan(lambda r, s: 10 ** 9) is None


def test_padded_stride_has_an_odd_number_of_chunks():
    for d in range(1, 300):
        ld = _rowstream.padded_stride(d)
        assert ld >= d and ld % 4 == 0 and (ld // 4) % 2 == 1


def test_cpu_dispatch_counts_no_variant():
    ops.reset_launch_counts()
    a = torch.zeros((300, 8))
    ops.kmeans_assign(a, a[:3])
    ops.pairwise_sqdist(a, a[:3])
    assert ops.variant_counts() == {
        "pairwise_sqdist": {"stream": 0, "tiled": 0, "batched": 0},
        "kmeans_assign": {"small": 0, "stream": 0},
        "group_ball_proj_batched": {"plain": 0, "ama_step": 0}}


@pytest.mark.parametrize("m", [SMALL - 1, SMALL, SMALL + 1])
def test_plain_versions_match_the_reference_at_the_threshold(m):
    rng = np.random.default_rng(m)
    cts = rng.normal(size=(8, 64)).astype(np.float32)
    pts = (cts[np.arange(m) % 8] + 0.5 * rng.normal(size=(m, 64))).astype(
        np.float32)
    lab, sums, cnt = ops.kmeans_assign(torch.from_numpy(pts),
                                       torch.from_numpy(cts))
    wl, ws, wc = (np.asarray(x) for x in jref.kmeans_assign(
        jnp.asarray(pts), jnp.asarray(cts)))
    np.testing.assert_array_equal(lab.numpy(), wl)
    np.testing.assert_allclose(sums.numpy(), ws, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(cnt.numpy(), wc)
    d2 = ops.pairwise_sqdist(torch.from_numpy(pts), torch.from_numpy(cts))
    want = np.asarray(jref.pairwise_sqdist(jnp.asarray(pts), jnp.asarray(cts)))
    np.testing.assert_allclose(d2.numpy(), want, rtol=1e-5, atol=1e-4)
