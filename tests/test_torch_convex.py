"""The port's convex family (ODCL-CC) against the JAX reference on the
same numpy inputs: the deterministic segment sum, the AMA iteration's
two passes (bit for bit against the PyTorch composition they replaced),
``device_convex_cluster``
(complete and kNN graphs, lambda given and ``None``, ``warm_nu``),
``device_clusterpath`` (complete, kNN and the LSH kNN graph with the
reference's directions carried across), the host ``convex_clustering``,
``clusterpath``, ``lambda_interval`` and ``knn_weights``, the session's
convex finalize and the CPU ``simulate``.

Tolerance: labels, ``n_clusters`` and route labels identical; ``u``
within atol 1e-5 * (1 + max|a|) (fp32 AMA iterations whose sums and row
norms round in another order); ``lam`` within rtol 1e-6, plus, where it
derives from the minimum pairwise distance (``lam=None``, the ladder's
lowest rung), what that distance inherits from the rounding of its fp32
expansion ||a||^2 + ||b||^2 - 2 a.b ((d + 3) * 2^-23 * 2 max ||a||^2 on
its square); ``n_iter`` equal, unless the port's last dual step lies
within 1e-6 relative of the stop threshold.  The threshold,
1e-7 * (1 + max|a|), is about one ulp of a, so where the AMA does meet
it the count is decided by rounding: the parity cases use iteration
budgets that both packages run to the end with the last dual step far
above the threshold, and ``test_ama_stops_at_its_tolerance`` covers the
early stop on the port alone.  ``knn_weights`` within rtol 1e-6 on top
of phi times the same expansion rounding; ``lambda_interval`` exactly
(the same float64 NumPy).  Data are planted Gaussian blobs without ties.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.clustering import convex as jconvex
from repro.core.engine import device_convex as jdc
from repro.core.engine.session import AggregationSession as JSession
from repro_torch import runtime
from repro_torch.core.clustering import api as tapi
from repro_torch.core.clustering import convex as tconvex
from repro_torch.core.engine import device_convex as tdc
from repro_torch.core.engine import edges as tedges
from repro_torch.interop import directions_from_numpy
from repro_torch.kernels import group_prox as tprox
from repro_torch.kernels import ops
from repro_torch.core.engine.segment import segment_plan, segment_sum
from repro_torch.core.engine.session import AggregationSession
from repro_torch.launch import simulate as tsimulate

KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One host thread: the tensors here are small, and parallel test
    workers must not oversubscribe the CPU."""
    with runtime.pinned_threads(1):
        yield


def make_blobs(seed, k=3, per=10, d=6, sep=30.0, noise=0.1):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d))
    dists = np.linalg.norm(centers[:, None] - centers[None], axis=-1)
    np.fill_diagonal(dists, np.inf)
    centers *= sep / dists.min()
    pts = np.concatenate(
        [c + noise * rng.normal(size=(per, d)) for c in centers])
    return pts.astype(np.float32), np.repeat(np.arange(k), per)


def interval_lambda(pts, labels):
    lo, hi = jconvex.lambda_interval(pts, labels)
    assert lo < hi
    return 0.5 * (lo + hi)


def min_dist_rounding(pts):
    """What lam = min_dist / (2(m-1)) inherits from the fp32 expansion."""
    p = pts.astype(np.float64)
    d2 = ((p[:, None] - p[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    on_square = (pts.shape[1] + 3) * 2.0 ** -23 * 2 * (p ** 2).sum(1).max()
    return on_square / (2 * np.sqrt(d2.min())) / (2 * (len(pts) - 1))


def assert_same_solve(port, ref, pts, lam_from_data=False):
    np.testing.assert_array_equal(port.labels.numpy(), np.asarray(ref.labels))
    assert int(port.n_clusters) == int(ref.n_clusters)
    atol = 1e-5 * (1.0 + float(np.abs(pts).max()))
    np.testing.assert_allclose(port.u.numpy(), np.asarray(ref.u), rtol=0,
                               atol=atol)
    np.testing.assert_allclose(port.centers.numpy(), np.asarray(ref.centers),
                               rtol=0, atol=atol)
    lam, ref_lam = float(port.lam), float(ref.lam)
    assert abs(lam - ref_lam) <= 1e-6 * abs(ref_lam) + (
        min_dist_rounding(pts) if lam_from_data else 0.0)
    if port.n_iter != int(ref.n_iter):
        # the stop test compared a dual step that sits on the threshold
        assert abs(port.moved - port.thresh) <= 1e-6 * port.thresh, (
            port.n_iter, int(ref.n_iter), port.moved, port.thresh)


# ------------------------------------------------------- segment sums

def test_segment_sum_is_the_scatter_add():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 9, size=200)
    vals = rng.normal(size=(3, 200, 5)).astype(np.float32)
    plan = segment_plan(torch.from_numpy(ids), 12)
    got = segment_sum(torch.from_numpy(vals), plan, axis=1)
    want = np.asarray(jnp.zeros((3, 12, 5)).at[:, ids].add(vals))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert not got.numpy()[:, 9:].any()                # empty segments
    again = segment_sum(torch.from_numpy(vals), plan, axis=1)
    assert torch.equal(got, again)
    # sorted ids (the complete graph's heads) skip the gather
    assert segment_plan(torch.arange(5).repeat_interleave(3), 5).order is None


# ------------------------------------------- device_convex_cluster

@pytest.mark.parametrize("edges,k,iters", [("complete", 3, 15),
                                           ("knn", 2, 25)])
def test_device_convex_matches_reference(edges, k, iters):
    pts, true = make_blobs(k, k=k)
    lam = interval_lambda(pts, true)
    ref = jdc.device_convex_cluster(KEY, jnp.asarray(pts), lam=lam,
                                    iters=iters, edges=edges, knn_k=4)
    port = tdc.device_convex_cluster(None, torch.from_numpy(pts), lam=lam,
                                     iters=iters, edges=edges, knn_k=4)
    assert int(port.n_clusters) == k and port.moved > 10 * port.thresh
    assert_same_solve(port, ref, pts)
    # warm start from the reference's own dual lands on its warm solve
    ref_w = jdc.device_convex_cluster(KEY, jnp.asarray(pts), lam=lam,
                                      iters=15, edges=edges, knn_k=4,
                                      warm_nu=ref.nu)
    port_w = tdc.device_convex_cluster(None, torch.from_numpy(pts), lam=lam,
                                       iters=15, edges=edges, knn_k=4,
                                       warm_nu=torch.from_numpy(
                                           np.array(ref.nu)))
    assert port_w.moved > 10 * port_w.thresh
    assert_same_solve(port_w, ref_w, pts)


def test_ama_stops_at_its_tolerance():
    pts, true = make_blobs(3, k=3)
    res = tdc.device_convex_cluster(None, torch.from_numpy(pts),
                                    lam=interval_lambda(pts, true), iters=300)
    assert res.n_iter < 300 and res.moved <= res.thresh
    assert int(res.n_clusters) == 3


@pytest.mark.parametrize("edges", ["complete", "knn"])
def test_ama_broadcasts_one_radius_per_rung_on_the_uniform_graph(
        monkeypatch, edges):
    """The complete graph's one weight reaches the prox as one radius per
    rung, (L, 1), with the same u as a radius per edge; the kNN graph's
    per-edge weights reach it as (L, E)."""
    pts, _ = make_blobs(2, k=3)
    a = torch.from_numpy(pts)
    es = tedges.get_edge_set(edges)(a)
    lams = torch.tensor([0.1, 0.2])
    seen = []
    prox = tdc.kops.group_ball_proj_batched

    def spy(v, radius, **step):
        seen.append(tuple(radius.shape))
        return prox(v, radius, **step)

    monkeypatch.setattr(tdc.kops, "group_ball_proj_batched", spy)
    u, _, n_iter, _, _ = tdc._ama_fixed_point(a, lams, es, iters=3, tol=1e-7)
    uniform = edges == "complete"
    assert n_iter == 3
    assert seen == [(2, 1 if uniform else es.n_edges)] * 3
    if uniform:
        full = es._replace(weights=es.weights.contiguous())
        u_full = tdc._ama_fixed_point(a, lams, full, iters=3, tol=1e-7)[0]
        assert seen[3:] == [(2, es.n_edges)] * 3
        assert torch.equal(u, u_full)


# ------------------------------- the AMA iteration's two passes
#
# The loop body used to be a PyTorch composition: u by two segment sums
# (a stable int64 argsort gathered with index_select, then
# segment_reduce), the edge gathers, the gradient step, the prox and the
# max |new - nu|.  The kernels' plain versions must give its bits.

def _edge_list(kind, m, seed):
    """(i_idx, j_idx) int64: the complete graph (heads sorted, so their
    plan has no order), the kNN graph of blobs, or random pairs that leave
    some nodes in no edge (empty segments on both sides)."""
    if kind == "complete":
        es = tedges.CompleteEdges()(torch.zeros((m, 2)))
        return es.i_idx, es.j_idx
    if kind == "knn":
        pts, _ = make_blobs(seed, k=3, per=m // 3)
        es = tedges.get_edge_set("knn")(torch.from_numpy(pts), knn_k=4)
        return es.i_idx, es.j_idx
    rng = np.random.default_rng(seed)
    i = rng.integers(0, m - 5, size=3 * m)
    j = rng.integers(0, m - 5, size=3 * m)
    keep = i != j
    return (torch.from_numpy(np.minimum(i, j)[keep]),
            torch.from_numpy(np.maximum(i, j)[keep]))


def _old_segment_sum(values, ids, m):
    ids = ids.long()
    lengths = torch.bincount(ids, minlength=m).expand(
        values.shape[0], -1).contiguous()
    if ids.numel() > 1 and not bool((ids[1:] >= ids[:-1]).all()):
        values = torch.index_select(values, 1,
                                    torch.argsort(ids, stable=True))
    return torch.segment_reduce(values, "sum", lengths=lengths, axis=1,
                                unsafe=True)


def _old_iteration(a, nu, radius, i_idx, j_idx, eta):
    """The loop body the two passes replace: (u, new_nu, max|new - nu|)."""
    m = a.shape[0]
    u = a[None] + (_old_segment_sum(nu, i_idx, m)
                   - _old_segment_sum(nu, j_idx, m))
    grad = u[:, i_idx] - u[:, j_idx]
    new = tprox.group_ball_proj_batched_ref(nu - eta * grad, radius)
    return u, new, torch.max(torch.abs(new - nu))


def _radius(layout, lams, e):
    if layout == "scalar":
        return torch.tensor(float(lams[0]))
    if layout == "rung":
        return lams[:, None] * torch.ones(1)
    rng = np.random.default_rng(e)
    w = torch.from_numpy(rng.uniform(0.0, 2.0, size=e).astype(np.float32))
    w[::7] = 0.0                                        # inert slots
    return lams[:, None] * w[None, :]


@pytest.mark.parametrize("kind", ["complete", "knn", "unsorted"])
@pytest.mark.parametrize("L", [1, 10])
@pytest.mark.parametrize("layout", ["scalar", "rung", "edge"])
def test_ama_passes_equal_the_old_composition_bit_for_bit(kind, L, layout):
    m, d = 30, 5
    i_idx, j_idx = _edge_list(kind, m, seed=L)
    e = i_idx.numel()
    rng = np.random.default_rng(e + L)
    a = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32))
    nu = torch.from_numpy(rng.normal(size=(L, e, d)).astype(np.float32))
    lams = torch.from_numpy(rng.uniform(0.1, 2.0, size=L).astype(np.float32))
    radius = _radius(layout, lams, e)
    eta = torch.tensor(1.0 / (2 * m), dtype=torch.float32)
    heads, tails = segment_plan(i_idx, m), segment_plan(j_idx, m)
    assert (heads.order is None) == (kind == "complete")
    want_u, want_nu, want_moved = _old_iteration(a, nu, radius, i_idx, j_idx,
                                                 eta)
    u = torch.full((L, m, d), float("nan"))
    assert ops.ama_gather_back(a, nu, heads, tails, u) is u
    assert torch.equal(u, want_u)
    # empty segments: nodes without heads, without tails, in no edge
    assert bool((heads.lengths == 0).any() and (tails.lengths == 0).any())
    if kind == "unsorted":
        idle = torch.bincount(torch.cat([i_idx, j_idx]), minlength=m) == 0
        assert bool(idle.any())
        assert torch.equal(u[:, idle], a[None, idle].expand(L, -1, -1))
    # in place, as the loop steps its one dual
    moved = torch.full((), -1.0)
    got = ops.group_ball_proj_batched(
        nu, radius, u=u, i_idx=i_idx.to(torch.int32),
        j_idx=j_idx.to(torch.int32), eta=eta, moved=moved)
    assert got is nu and torch.equal(nu, want_nu)
    assert torch.equal(moved, want_moved)


@pytest.mark.parametrize("edges,L", [("complete", 1), ("knn", 1),
                                     ("complete", 3)])
def test_ama_loop_equals_the_old_loop_bit_for_bit(edges, L):
    pts, _ = make_blobs(4, k=3)
    a = torch.from_numpy(pts)
    es = tedges.get_edge_set(edges)(a, knn_k=4)
    lams = torch.linspace(0.5, 1.5, L)
    u, nu, n_iter, moved, _ = tdc._ama_fixed_point(a, lams, es, iters=12,
                                                   tol=1e-7)
    eta = torch.as_tensor(1.0 / es.inv_eta, dtype=torch.float32)
    radius = lams[:, None] * es.weights[None, :]
    want = a.new_zeros((L, es.n_edges, a.shape[1]))
    for _ in range(12):
        _, want, step = _old_iteration(a, want, radius, es.i_idx, es.j_idx,
                                       eta)
    m = a.shape[0]
    want_u = a[None] + (_old_segment_sum(want, es.i_idx, m)
                        - _old_segment_sum(want, es.j_idx, m))
    assert n_iter == 12 and moved == float(step / eta)
    assert torch.equal(nu, want) and torch.equal(u, want_u)


def test_a_warm_dual_is_left_unchanged():
    pts, true = make_blobs(3, k=3)
    lam = interval_lambda(pts, true)
    cold = tdc.device_convex_cluster(None, torch.from_numpy(pts), lam=lam,
                                     iters=10)
    warm_nu = cold.nu.clone()
    warm = tdc.device_convex_cluster(None, torch.from_numpy(pts), lam=lam,
                                     iters=10, warm_nu=warm_nu)
    assert torch.equal(warm_nu, cold.nu)
    assert warm.nu.data_ptr() != warm_nu.data_ptr()
    assert not torch.equal(warm.nu, cold.nu)


def test_device_convex_default_lambda_matches_reference():
    pts, _ = make_blobs(5, k=3, per=8, noise=0.5)
    ref = jdc.device_convex_cluster(KEY, jnp.asarray(pts), iters=5)
    port = tdc.device_convex_cluster(None, torch.from_numpy(pts), iters=5)
    assert port.moved > 10 * port.thresh
    assert_same_solve(port, ref, pts, lam_from_data=True)


def test_device_convex_degenerate_sizes():
    one = tdc.device_convex_cluster(None, torch.ones((1, 4)))
    assert int(one.n_clusters) == 1 and one.n_iter == 0
    assert float(one.lam) == pytest.approx(1e-3)
    u, nu, n_iter, _, _ = tdc._ama_fixed_point(
        torch.ones((3, 4)), torch.ones(2),
        tedges.CompleteEdges()(torch.ones((1, 4))), iters=5, tol=1e-7)
    assert n_iter == 0 and tuple(nu.shape) == (2, 0, 4)
    assert torch.equal(u, torch.ones((2, 3, 4)))
    with pytest.raises(ValueError, match="weights"):
        tdc.device_convex_cluster(None, torch.ones((4, 2)), edges="knn",
                                  weights=torch.ones(6))


# ------------------------------------------------ device_clusterpath

@pytest.mark.parametrize("edges", ["complete", "knn"])
def test_device_clusterpath_matches_reference(edges):
    pts, _ = make_blobs(7, k=3, per=10)
    ref = jdc.device_clusterpath(KEY, jnp.asarray(pts), iters=40,
                                 edges=edges, knn_k=4)
    port = tdc.device_clusterpath(None, torch.from_numpy(pts), iters=40,
                                  edges=edges, knn_k=4)
    assert int(port.n_clusters) == 3 and port.moved > 10 * port.thresh
    assert_same_solve(port, ref, pts, lam_from_data=True)


def test_device_clusterpath_on_the_lsh_graph_matches_reference():
    pts, _ = make_blobs(6, k=4, per=50, d=8, sep=12.0, noise=0.5)  # m = 200
    key = jax.random.PRNGKey(0)
    dirs = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, t), (8,), jnp.float32)) for t in range(4)])
    for v in dirs:                     # no near-ties in the LSH orders
        proj = np.sort(pts.astype(np.float64) @ v.astype(np.float64))
        assert np.min(np.diff(proj)) > 16 * 2.0 ** -24 * float(
            (np.abs(pts) @ np.abs(v)).max())

    def lsh(points, knn_k):
        return tedges.ApproxKnnEdges()(
            points, knn_k=knn_k, directions=directions_from_numpy(dirs, "cpu"))

    assert pts.shape[0] > 3 * 64                             # LSH runs
    ref = jdc.device_clusterpath(KEY, jnp.asarray(pts), iters=300,
                                 edges="knn-approx", knn_k=4)
    port = tdc.device_clusterpath(None, torch.from_numpy(pts), iters=300,
                                  edges=lsh, knn_k=4)
    assert int(port.n_clusters) == 4 and port.moved > 10 * port.thresh
    assert_same_solve(port, ref, pts, lam_from_data=True)


def test_ladder_is_jnp_linspace():
    lo, hi = torch.tensor(0.0123), torch.tensor(0.9876)
    got = tdc._linspace(lo, hi, 10).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jnp.linspace(jnp.float32(0.0123),
                                     jnp.float32(0.9876), 10)), rtol=1e-6)
    assert got[0] == np.float32(0.0123) and got[-1] == np.float32(0.9876)


# ------------------------------------------------------ host solver

def test_host_convex_clustering_matches_reference():
    pts, true = make_blobs(1, k=2, per=12)
    lam = interval_lambda(pts, true)
    ref = jconvex.convex_clustering(jnp.asarray(pts), lam, iters=300)
    port = tconvex.convex_clustering(torch.from_numpy(pts), lam, iters=300)
    np.testing.assert_array_equal(port.labels, ref.labels)
    assert port.n_clusters == ref.n_clusters == 2
    atol = 1e-5 * (1.0 + float(np.abs(pts).max()))
    np.testing.assert_allclose(port.u.numpy(), np.asarray(ref.u), rtol=0,
                               atol=atol)
    np.testing.assert_allclose(port.centers, ref.centers, rtol=0, atol=atol)
    # weighted: the kNN Gaussian weights, per-edge radii
    w_ref = jconvex.knn_weights(jnp.asarray(pts), k=3)
    w = tconvex.knn_weights(torch.from_numpy(pts), k=3)
    cancel = 0.5 * 4 * 2.0 ** -23 * float((pts.astype(np.float64) ** 2)
                                          .sum(1).max())
    assert np.all(np.abs(w.numpy() - np.asarray(w_ref))
                  <= np.asarray(w_ref) * (1e-6 + cancel))
    np.testing.assert_array_equal(w.numpy() > 0, np.asarray(w_ref) > 0)
    ref_w = jconvex.convex_clustering(jnp.asarray(pts), lam, iters=300,
                                      weights=w_ref)
    port_w = tconvex.convex_clustering(torch.from_numpy(pts), lam, iters=300,
                                       weights=torch.from_numpy(
                                           np.array(w_ref)))
    np.testing.assert_array_equal(port_w.labels, ref_w.labels)
    np.testing.assert_allclose(port_w.u.numpy(), np.asarray(ref_w.u),
                               rtol=0, atol=atol)


@pytest.mark.parametrize("seed,k", [(0, 2), (3, 4)])
def test_lambda_interval_is_the_reference(seed, k):
    pts, true = make_blobs(seed, k=k, per=7)
    assert tconvex.lambda_interval(pts, true) == \
        jconvex.lambda_interval(pts, true)
    assert tconvex.lambda_interval(torch.from_numpy(pts), true) == \
        jconvex.lambda_interval(pts, true)
    single = np.arange(len(pts))
    assert tconvex.lambda_interval(pts, single) == \
        jconvex.lambda_interval(pts, single)


def test_host_clusterpath_matches_reference():
    pts, _ = make_blobs(2, k=3, per=6, d=4)
    best_ref, res_ref = jconvex.clusterpath(jnp.asarray(pts), n_lambdas=5,
                                            iters=100)
    best, res = tconvex.clusterpath(torch.from_numpy(pts), n_lambdas=5,
                                    iters=100)
    assert [r.n_clusters for r in res] == [r.n_clusters for r in res_ref]
    np.testing.assert_array_equal(best.labels, best_ref.labels)
    assert best.n_clusters == best_ref.n_clusters == 3
    assert best.lam == pytest.approx(best_ref.lam, rel=1e-12)


# ------------------------------------------------- registry, session

def test_registry_twins_and_resolution():
    names = set(tapi.list_algorithms())
    assert {"convex", "clusterpath", "convex-device",
            "clusterpath-device"} <= names
    for name in ("convex-device", "clusterpath-device"):
        algo = tapi.get_algorithm(name)
        assert tapi.is_device_algorithm(algo) and not algo.requires_k
        assert tapi.device_twin(algo) is None
    assert tapi.device_twin(tapi.get_algorithm("convex")).name == \
        "convex-device"
    assert tapi.device_twin(tapi.get_algorithm("clusterpath")).name == \
        "clusterpath-device"
    assert tapi.device_twin(tapi.get_algorithm("kmeans-device")) is None
    assert tapi.resolve_device_request("convex", {"lam": 1.0}) == \
        ("convex", {"lam": 1.0})
    assert tapi.get_algorithm("convex-device").warm_requires_same_count


def test_adapters_report_the_meta_contract():
    pts, true = make_blobs(3, k=3)
    lam = interval_lambda(pts, true)
    algo = tapi.get_algorithm("convex-device")
    res = algo.device_call(None, torch.from_numpy(pts), lam=lam, iters=300)
    meta = tapi.meta_to_host(res.meta)
    assert set(meta) == set(tapi.DEVICE_META_KEYS)
    assert meta["n_clusters"] == 3 and meta["restart_spread"] is None
    assert meta["lam"] == pytest.approx(lam, rel=1e-6)
    assert res.aux is not None and algo.warm_state(res) is res.aux
    warm = algo.device_warm_call(None, torch.from_numpy(pts),
                                 algo.warm_state(res), lam=lam, iters=300)
    assert tapi.meta_to_host(warm.meta)["n_iter"] <= meta["n_iter"]
    for name in ("convex-device", "convex", "clusterpath-device"):
        out = tapi.get_algorithm(name)(None, torch.from_numpy(pts), iters=300,
                                       **({"lam": lam} if "convex" in name
                                          else {}))
        assert out.n_clusters == 3 and sorted(set(out.labels)) == [0, 1, 2]


def test_session_convex_and_twin_match_reference():
    pts, true = make_blobs(4, k=3, per=12, d=8)
    probes = pts[::5] + 0.01
    lam = interval_lambda(pts, true)
    opts = {"lam": lam, "iters": 300}
    ref = JSession(len(pts), sketch_dim=8)
    ref.ingest(sketches=jnp.asarray(pts))
    _, ref_labels, _ = ref.finalize(algorithm="convex-device",
                                    algo_options=opts, engine="device")
    ref_routed = np.asarray(ref.route(jnp.asarray(probes)))
    for name in ("convex", "convex-device"):
        sess = AggregationSession(len(pts), sketch_dim=8, device="cpu")
        sess.ingest(sketches=torch.from_numpy(pts))
        _, labels, info = sess.finalize(algorithm=name, algo_options=opts)
        np.testing.assert_array_equal(labels, ref_labels)
        assert info["n_clusters"] == 3
        np.testing.assert_array_equal(
            sess.route(torch.from_numpy(probes)), ref_routed)


def test_simulate_convex_knn_recovers_clusters_on_the_cpu(capsys):
    summary = tsimulate.main(["--algorithm", "convex-device", "--edges",
                              "knn", "--clients", "512", "--sketch-dim", "32",
                              "--cc-iters", "200", "--device", "cpu"])
    assert summary["purity"] == 1.0
    assert summary["n_clusters_recovered"] == 8
    assert summary["edges"] == "knn" and summary["knn_k"] == 8
    assert summary["lam"] > 0 and summary["meta"]["n_iter"] <= 200
    assert "edges=knn" in capsys.readouterr().out
