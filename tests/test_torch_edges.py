"""The port's fusion graphs (``repro_torch.core.engine.edges``) against
the JAX reference's (``repro.core.engine.edges``) on the same numpy
points: ``complete``, the exact mutual-kNN ``knn`` and the LSH
``knn-approx`` above 3*bucket, with the reference's ``jax.random``
directions carried across.

Tolerance: ``i_idx``, ``j_idx`` and ``inv_eta`` exactly; ``weights``
within rtol 1e-6; ``min_dist`` within rtol 1e-6 on top of the rounding
of the expansion ||a||^2 + ||b||^2 - 2 a.b that both packages compute
it by (their fp32 dot products round in different orders, so its
square may differ by 4 * 2^-23 * max ||a||^2); neighbour distances
within rtol 1e-5 / atol 1e-5.  The data are Gaussian blobs with no
ties among neighbour distances or LSH projections (``torch.topk`` and
``lax.top_k`` may break ties differently), which the LSH test asserts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import edges as jedges
from repro_torch import runtime
from repro_torch.core.engine import edges as tedges
from repro_torch.interop import directions_from_numpy


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One host thread: the tensors here are small, and parallel test
    workers must not oversubscribe the CPU."""
    with runtime.pinned_threads(1):
        yield


def make_blobs(seed, k=3, per=20, d=8, sep=12.0, noise=0.5):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d))
    dists = np.linalg.norm(centers[:, None] - centers[None], axis=-1)
    np.fill_diagonal(dists, np.inf)
    centers *= sep / dists.min()
    pts = np.concatenate(
        [c + noise * rng.normal(size=(per, d)) for c in centers])
    return pts.astype(np.float32), np.repeat(np.arange(k), per)


def reference_directions(seed, n_tables, d):
    key = jax.random.PRNGKey(seed)
    return np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, t),
                                                  (d,), jnp.float32))
                     for t in range(n_tables)])


def assert_same_edges(port, ref, pts):
    np.testing.assert_array_equal(port.i_idx.numpy(), np.asarray(ref.i_idx))
    np.testing.assert_array_equal(port.j_idx.numpy(), np.asarray(ref.j_idx))
    np.testing.assert_allclose(port.weights.numpy(), np.asarray(ref.weights),
                               rtol=1e-6)
    assert float(port.inv_eta) == float(ref.inv_eta)
    assert (port.min_dist is None) == (ref.min_dist is None)
    if ref.min_dist is not None:
        got, want = float(port.min_dist), float(ref.min_dist)
        cancel = 4 * 2.0 ** -23 * float((pts.astype(np.float64) ** 2)
                                        .sum(1).max())
        assert abs(got * got - want * want) <= 1e-6 * want * want + cancel


def test_registry_round_trip():
    assert set(tedges.list_edge_sets()) == {"complete", "knn", "knn-approx"}
    builder = tedges.get_edge_set("knn")
    assert tedges.get_edge_set(builder) is builder
    with pytest.raises(KeyError, match="unknown edge set"):
        tedges.get_edge_set("nope")
    with pytest.raises(ValueError, match="already registered"):
        tedges.register_edge_set(tedges.KnnEdges())
    tedges.register_edge_set(tedges.KnnEdges(), name="knn-copy")
    try:
        assert "knn-copy" in tedges.list_edge_sets()
    finally:
        tedges.unregister_edge_set("knn-copy")
    assert "knn-copy" not in tedges.list_edge_sets()


@pytest.mark.parametrize("m", [5, 37])
def test_complete_edges_match_reference(m):
    pts, _ = make_blobs(m, per=m, k=1)
    port = tedges.CompleteEdges()(torch.from_numpy(pts))
    ref = jedges.CompleteEdges()(jnp.asarray(pts))
    assert_same_edges(port, ref, pts)
    assert isinstance(port.inv_eta, float) and port.n_edges == m * (m - 1) // 2


def test_complete_edges_guard():
    pts = torch.zeros((10, 2))
    with pytest.raises(ValueError, match="knn"):
        tedges.CompleteEdges()(pts, max_m=9)
    assert tedges.CompleteEdges()(pts, max_m=10).n_edges == 45
    assert tedges.COMPLETE_EDGES_MAX_M == jedges.COMPLETE_EDGES_MAX_M


@pytest.mark.parametrize("seed,k,tile", [(0, 4, 16), (1, 8, 1024),
                                         (2, 1, 7)])
def test_knn_edges_match_reference(seed, k, tile):
    pts, _ = make_blobs(seed)
    port = tedges.KnnEdges()(torch.from_numpy(pts), knn_k=k, tile=tile)
    ref = jedges.KnnEdges()(jnp.asarray(pts), knn_k=k)
    assert_same_edges(port, ref, pts)
    idx, dist = tedges._tiled_topk(torch.from_numpy(pts), k, tile)
    ridx, rdist = jedges._tiled_topk(jnp.asarray(pts), k, 1024)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_allclose(dist.numpy(), np.asarray(rdist), rtol=1e-5,
                               atol=1e-5)


def test_knn_approx_lsh_stage_matches_reference():
    pts, _ = make_blobs(3, k=4, per=16)                     # m = 64
    k, bucket, tables = 3, 8, 4
    assert pts.shape[0] > 3 * bucket                         # LSH runs
    dirs = reference_directions(0, tables, pts.shape[1])
    # no near-ties in any table's 1-D order: every gap exceeds the worst
    # rounding of two fp32 dot products of d terms
    for v in dirs:
        proj = np.sort(pts.astype(np.float64) @ v.astype(np.float64))
        bound = 2 * pts.shape[1] * 2.0 ** -24 * float(
            (np.abs(pts) @ np.abs(v)).max())
        assert np.min(np.diff(proj)) > bound
    port = tedges.ApproxKnnEdges()(
        torch.from_numpy(pts), knn_k=k, n_tables=tables, bucket=bucket,
        directions=directions_from_numpy(dirs, "cpu"))
    ref = jedges.ApproxKnnEdges()(jnp.asarray(pts), knn_k=k,
                                  n_tables=tables, bucket=bucket, seed=0)
    assert_same_edges(port, ref, pts)
    idx, d2 = tedges._bucketed_topk(
        torch.from_numpy(pts), k, bucket=bucket,
        directions=directions_from_numpy(dirs, "cpu"))
    ridx, rd2 = jedges._bucketed_topk(jnp.asarray(pts), k, n_tables=tables,
                                      bucket=bucket, seed=0)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_allclose(d2.numpy(), np.asarray(rd2), rtol=1e-5,
                               atol=1e-5)


def test_knn_approx_draws_its_own_tables_the_same_on_every_call():
    pts, _ = make_blobs(4, k=4, per=50)
    a = tedges.ApproxKnnEdges()(torch.from_numpy(pts), knn_k=3, bucket=16)
    b = tedges.ApproxKnnEdges()(torch.from_numpy(pts), knn_k=3, bucket=16,
                                directions=tedges.lsh_directions(4, 8))
    assert torch.equal(a.i_idx, b.i_idx) and torch.equal(a.j_idx, b.j_idx)
    # the found neighbours are real neighbours: each active pair is within
    # the point's cluster for well separated blobs
    _, labels = make_blobs(4, k=4, per=50)
    keep = a.weights > 0
    assert (labels[a.i_idx[keep].numpy()] == labels[a.j_idx[keep].numpy()]
            ).all()


def test_knn_approx_small_m_is_the_exact_builder():
    pts, _ = make_blobs(5, k=2, per=20)                      # m = 40 <= 3*64
    approx = tedges.ApproxKnnEdges()(torch.from_numpy(pts), knn_k=4)
    exact = tedges.KnnEdges()(torch.from_numpy(pts), knn_k=4)
    for x, y in zip(approx, exact):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))
    assert_same_edges(approx, jedges.ApproxKnnEdges()(jnp.asarray(pts),
                                                      knn_k=4), pts)


@pytest.mark.parametrize("name", ["complete", "knn", "knn-approx"])
@pytest.mark.parametrize("m", [1, 2, 3])
def test_degenerate_sizes_match_reference(name, m):
    pts, _ = make_blobs(m, k=1, per=m)
    port = tedges.get_edge_set(name)(torch.from_numpy(pts), knn_k=8)
    ref = jedges.get_edge_set(name)(jnp.asarray(pts), knn_k=8)
    assert port.n_edges == ref.n_edges
    assert_same_edges(port, ref, pts)
