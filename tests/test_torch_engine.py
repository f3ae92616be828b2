"""The port's server round against the JAX reference, on the CPU.

Both packages get the same inputs: client parameters made with numpy,
the reference's JL projection (``ref_projection``) and the reference's
kmeans++ centers as a warm start, carried across by
``repro_torch.interop``.  Partitions and route labels must be identical;
floats agree within rtol 1e-5 (atol 1e-5 on values of order one).  The
port's inertia is held to the direct sum of squared distances of the
reference's labels and centers, not to the reference's reported inertia,
which is computed by a formula that loses digits to cancellation
(``repro/core/engine/device_kmeans.py:115-121``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.clustering.kmeans import kmeans_plus_plus_init as jkmeanspp
from repro.core.engine.aggregate import (
    one_shot_aggregate_device as j_one_shot,
)
from repro.core.engine.device_kmeans import device_kmeans as jdevice_kmeans
from repro.core.engine.session import AggregationSession as JSession
from repro.core.federated import FederatedState as JState
from repro.core.sketch import sketch_tree as jsketch_tree
from repro_torch.core.clustering.api import (
    DEVICE_META_KEYS,
    get_algorithm,
    meta_to_host,
    resolve_device_request,
)
from repro_torch.core.engine.aggregate import (
    compact_labels,
    one_shot_aggregate_device,
)
from repro_torch.core.engine.device_kmeans import device_kmeans
from repro_torch.core.engine.session import AggregationSession
from repro_torch.core.erm import batched_ridge_erm, ridge_erm
from repro_torch.core.federated import cluster_agreement
from repro_torch.core.sketch import make_generator
from repro_torch.interop import (
    centers_from_numpy,
    params_from_numpy,
    projection_from_numpy,
    state_from_numpy,
)
from repro_torch.launch.simulate import simulate

from conftest import same_partition
from test_torch_sketch import ref_projection

CPU = "cpu"


def make_blobs(seed, sizes, d, sep=6.0, noise=1.0):
    rng = np.random.default_rng(seed)
    k = len(sizes)
    centers = rng.normal(size=(k, d))
    dists = np.linalg.norm(centers[:, None] - centers[None], axis=-1)
    np.fill_diagonal(dists, np.inf)
    centers *= sep / dists.min()
    pts = np.concatenate([c + noise * rng.normal(size=(n, d))
                          for c, n in zip(centers, sizes)])
    return pts.astype(np.float32), np.repeat(np.arange(k), sizes)


def direct_inertia(pts, labels, centers):
    return float(np.sum((pts - centers[labels]) ** 2, dtype=np.float64))


# ------------------------------------------------------------- Lloyd

@pytest.mark.parametrize("seed,sizes,d,iters", [
    (0, [60, 50, 70, 40], 8, 50),
    (1, [30, 90, 45], 16, 50),
    (2, [100, 100, 100, 100, 100], 4, 3),
    (3, [7, 5], 2, 50),
])
def test_warm_lloyd_matches_reference(seed, sizes, d, iters):
    pts, _ = make_blobs(seed, sizes, d)
    k = len(sizes)
    c0 = np.asarray(jkmeanspp(jax.random.PRNGKey(seed), jnp.asarray(pts), k))
    want = jdevice_kmeans(jax.random.PRNGKey(seed), jnp.asarray(pts), k,
                          iters=iters, init="warm", init_centers=c0)
    got = device_kmeans(make_generator(seed, CPU), torch.from_numpy(pts), k,
                        iters=iters, init="warm",
                        init_centers=centers_from_numpy(c0, CPU))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(want.centers),
                               rtol=1e-5, atol=1e-5)
    assert got.n_iter == int(want.n_iter)
    np.testing.assert_allclose(
        float(got.inertia),
        direct_inertia(pts, np.asarray(want.labels), np.asarray(want.centers)),
        rtol=1e-5)


def test_lloyd_runs_several_iterations_in_the_parity_cases():
    pts, _ = make_blobs(0, [60, 50, 70, 40], 8)
    c0 = np.asarray(jkmeanspp(jax.random.PRNGKey(0), jnp.asarray(pts), 4))
    got = device_kmeans(make_generator(0, CPU), torch.from_numpy(pts), 4,
                        init="warm", init_centers=centers_from_numpy(c0, CPU))
    assert got.n_iter > 1


def test_own_kmeanspp_recovers_separated_blobs():
    pts, truth = make_blobs(4, [40, 40, 40, 40], 8, sep=25.0, noise=0.25)
    res = device_kmeans(make_generator(0, CPU), torch.from_numpy(pts), 4,
                        restarts=3)
    assert same_partition(res.labels.numpy(), truth)
    assert res.restart_spread >= 0.0


def test_restarts_never_worsen_inertia():
    pts, _ = make_blobs(5, [50, 20, 80, 30, 60], 4, sep=3.0)
    x = torch.from_numpy(pts)
    one = device_kmeans(make_generator(9, CPU), x, 5)
    many = device_kmeans(make_generator(9, CPU), x, 5, restarts=4)
    assert float(many.inertia) <= float(one.inertia) * (1 + 1e-6)


def test_random_init_and_bad_options():
    pts, truth = make_blobs(6, [25, 25, 25], 4, sep=25.0, noise=0.25)
    x = torch.from_numpy(pts)
    res = device_kmeans(make_generator(1, CPU), x, 3, init="random",
                        restarts=4)
    assert cluster_agreement(res.labels.numpy(), truth) == 1.0
    with pytest.raises(ValueError, match="unknown init"):
        device_kmeans(make_generator(1, CPU), x, 3, init="spectral")
    with pytest.raises(ValueError, match="init_centers"):
        device_kmeans(make_generator(1, CPU), x, 3, init="warm")
    algo = get_algorithm("kmeans-device")
    with pytest.raises(NotImplementedError, match="minibatch"):
        algo.device_call(make_generator(1, CPU), x, k=3, batch_m=10)
    with pytest.raises(NotImplementedError, match="robust"):
        algo.device_call(make_generator(1, CPU), x, k=3,
                         aggregator="trimmed_mean")


def test_device_meta_contract_and_lloyd_name_mapping():
    pts, _ = make_blobs(7, [20, 20], 4)
    res = get_algorithm("kmeans-device").device_call(
        make_generator(0, CPU), torch.from_numpy(pts), k=2, restarts=2)
    meta = meta_to_host(res.meta)
    assert tuple(meta) == DEVICE_META_KEYS
    assert meta["lam"] is None and meta["restarts"] == 2
    assert meta["n_clusters"] == 2 and isinstance(meta["n_iter"], int)
    assert resolve_device_request("kmeans++") == ("kmeans-device",
                                                  {"init": "kmeans++"})
    assert resolve_device_request("kmeans", {"iters": 3}) == (
        "kmeans-device", {"init": "random", "iters": 3})
    warm = get_algorithm("kmeans-device").device_warm_call(
        make_generator(0, CPU), torch.from_numpy(pts), res.centers, k=2)
    assert torch.equal(warm.labels, res.labels)


# ------------------------------------------------------------- ERM

def test_ridge_erm_matches_reference():
    from repro.core.erm import batched_ridge_erm as jbatched
    from repro.core.erm import ridge_erm as jridge

    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 64, 16)).astype(np.float32)
    y = rng.normal(size=(5, 64)).astype(np.float32)
    want = np.asarray(jbatched(jnp.asarray(x), jnp.asarray(y), 1e-6))
    got = batched_ridge_erm(torch.from_numpy(x), torch.from_numpy(y), 1e-6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    one = ridge_erm(torch.from_numpy(x[0]), torch.from_numpy(y[0]))
    np.testing.assert_allclose(
        one.numpy(), np.asarray(jridge(jnp.asarray(x[0]), jnp.asarray(y[0]))),
        rtol=1e-4, atol=1e-5)


# ------------------------------------------------- the slice as a whole

C, K, DIM, S, SEED = 512, 4, 16, 32, 3


def client_thetas(seed=0, n=C, draw=0):
    """``n`` clients around the K optima of ``seed``; ``draw`` picks
    another set of clients around the same optima."""
    optima = np.random.default_rng(seed).normal(size=(K, DIM)) * 4.0
    rng = np.random.default_rng([seed, draw])
    truth = np.arange(n) % K
    return (optima[truth] + 0.5 * rng.normal(size=(n, DIM))).astype(
        np.float32), truth


def ref_sketches(thetas):
    return np.asarray(jax.vmap(
        lambda t: jsketch_tree(jax.random.PRNGKey(SEED), {"theta": t}, S))(
            jnp.asarray(thetas)))


def warm_centers(sketches):
    return np.asarray(jkmeanspp(jax.random.PRNGKey(SEED),
                                jnp.asarray(sketches), K))


def test_one_shot_round_matches_reference():
    thetas, truth = client_thetas()
    c0 = warm_centers(ref_sketches(thetas))
    opts = {"init": "warm", "init_centers": c0}
    want_state, want_labels, want_info = j_one_shot(
        JState(params={"theta": jnp.asarray(thetas)}, opt_state=None,
               n_clients=C),
        algorithm="kmeans-device", k=K, algo_options=opts, sketch_dim=S,
        seed=SEED, return_sketches=True)
    got_state, got_labels, got_info = one_shot_aggregate_device(
        state_from_numpy({"theta": thetas}, CPU), algorithm="kmeans-device",
        k=K, algo_options={"init": "warm",
                           "init_centers": centers_from_numpy(c0, CPU)},
        sketch_dim=S, seed=SEED, return_sketches=True, device=CPU,
        projection=projection_from_numpy(ref_projection(SEED, DIM, S), CPU))
    np.testing.assert_allclose(got_info["sketches"], want_info["sketches"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got_labels, want_labels)
    np.testing.assert_allclose(got_state.params["theta"].numpy(),
                               np.asarray(want_state.params["theta"]),
                               rtol=1e-5, atol=1e-5)
    assert got_info["n_clusters"] == want_info["n_clusters"] == K
    assert got_info["meta"]["n_iter"] == want_info["meta"]["n_iter"]
    assert cluster_agreement(got_labels, truth) == 1.0


def _ingest_three_waves(session, thetas, reupload, put):
    """Waves of 200, 137 and 175 clients, keyed; the third wave also
    re-uploads clients 10..29 of the first with new parameters."""
    ids = np.arange(C)
    session.ingest({"theta": put(thetas[:200])},
                   client_ids=ids[:200].tolist())
    session.ingest({"theta": put(thetas[200:337])},
                   client_ids=ids[200:337].tolist())
    third = np.concatenate([thetas[337:], reupload])
    rows = session.ingest({"theta": put(third)},
                          client_ids=ids[337:].tolist() + list(range(10, 30)))
    return rows


def test_session_round_route_and_drift_match_reference():
    thetas, truth = client_thetas()
    reupload = (thetas[10:30] + 0.1).astype(np.float32)
    final = thetas.copy()
    final[10:30] = reupload
    c0 = warm_centers(ref_sketches(final))
    probes, probe_truth = client_thetas(n=96, draw=1)

    jsess = JSession(C + 8, sketch_dim=S, seed=SEED)
    jrows = _ingest_three_waves(jsess, thetas, reupload, jnp.asarray)
    jstate, jlabels, jinfo = jsess.finalize(
        algorithm="kmeans-device", k=K,
        algo_options={"init": "warm", "init_centers": c0})
    jprobe_sk = jsess.sketch_params({"theta": jnp.asarray(probes)})
    jroute = jsess.route(jprobe_sk)
    jone = jsess.route(params={"theta": jnp.asarray(probes[0])})

    proj = projection_from_numpy(ref_projection(SEED, DIM, S), CPU)
    tsess = AggregationSession(C + 8, sketch_dim=S, seed=SEED,
                               projection=proj, device=CPU)
    trows = _ingest_three_waves(tsess, thetas, reupload, torch.from_numpy)
    tstate, tlabels, tinfo = tsess.finalize(
        algorithm="kmeans-device", k=K,
        algo_options={"init": "warm",
                      "init_centers": centers_from_numpy(c0, CPU)})
    tprobe_sk = tsess.sketch_params(params_from_numpy({"theta": probes},
                                                      CPU))
    troute = tsess.route(tprobe_sk)
    tone = tsess.route(params={"theta": torch.from_numpy(probes[0])})

    np.testing.assert_array_equal(trows, jrows)
    assert tsess.count == jsess.count == C
    np.testing.assert_allclose(tsess.sketches.numpy(),
                               np.asarray(jsess.sketches),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tlabels, jlabels)
    np.testing.assert_allclose(tstate.params["theta"].numpy(),
                               np.asarray(jstate.params["theta"]),
                               rtol=1e-5, atol=1e-5)
    assert tinfo["meta"]["n_iter"] == jinfo["meta"]["n_iter"]
    np.testing.assert_allclose(tprobe_sk.numpy(), np.asarray(jprobe_sk),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(troute, np.asarray(jroute))
    assert tone == jone
    np.testing.assert_allclose(tsess.drift, jsess.drift, rtol=1e-5)
    assert cluster_agreement(troute, probe_truth) == 1.0
    for cid in range(K):
        np.testing.assert_allclose(
            tsess.cluster_model(cid)["theta"].numpy(),
            np.asarray(jsess.cluster_model(cid)["theta"]),
            rtol=1e-5, atol=1e-5)


def test_session_waves_equal_the_one_shot_round():
    thetas, _ = client_thetas(seed=2)
    proj = projection_from_numpy(ref_projection(SEED, DIM, S), CPU)
    opts = {"init": "kmeans++", "restarts": 2}
    state, labels, _ = one_shot_aggregate_device(
        state_from_numpy({"theta": thetas}, CPU), k=K, algo_options=opts,
        sketch_dim=S, seed=SEED, projection=proj, device=CPU)
    sess = AggregationSession(C, sketch_dim=S, seed=SEED, projection=proj,
                              device=CPU)
    for lo, hi in [(0, 100), (100, 101), (101, C)]:
        sess.ingest({"theta": torch.from_numpy(thetas[lo:hi])})
    sstate, slabels, _ = sess.finalize(k=K, algo_options=opts)
    np.testing.assert_array_equal(slabels, labels)
    assert torch.equal(sstate.params["theta"], state.params["theta"])
    assert torch.equal(sess.state().params["theta"],
                       torch.from_numpy(thetas))


def test_sketch_only_session_and_guard_rails():
    thetas, truth = client_thetas(seed=3)
    sess = AggregationSession(C, sketch_dim=DIM, device=CPU)
    with pytest.raises(ValueError, match="finalize"):
        sess.route(np.zeros(DIM, np.float32))
    with pytest.raises(ValueError, match="nothing ingested"):
        sess.finalize(k=K)
    assert sess.ingest(sketches=thetas[:300]) == 0
    assert sess.ingest(sketches=thetas[300:]) == 300
    with pytest.raises(ValueError, match="cannot mix"):
        sess.ingest({"theta": torch.zeros((2, DIM))})
    state, labels, info = sess.finalize(k=K)
    assert state is None and info["n_clusters"] == K
    assert cluster_agreement(labels, truth) == 1.0
    assert sess.route(thetas[5]) == labels[5]
    with pytest.raises(ValueError, match="no parameters"):
        sess.cluster_model(0)
    with pytest.raises(ValueError, match="capacity"):
        sess.ingest(sketches=thetas[:1])
    with pytest.raises(ValueError, match="empty batch"):
        sess.route(np.zeros((0, DIM), np.float32))


def test_keyed_waves_validate_before_changing_anything():
    sess = AggregationSession(10, sketch_dim=4, device=CPU)
    sess.ingest({"theta": torch.zeros((3, 2))}, client_ids=["a", "b", "c"])
    with pytest.raises(ValueError, match="duplicate"):
        sess.ingest({"theta": torch.zeros((2, 2))}, client_ids=["d", "d"])
    with pytest.raises(ValueError, match="entries"):
        sess.ingest({"theta": torch.zeros((2, 2))}, client_ids=["d"])
    with pytest.raises(ValueError, match="leaf shape"):
        sess.ingest({"theta": torch.zeros((2, 3))})
    with pytest.raises(ValueError, match="structure"):
        sess.ingest({"w": torch.zeros((2, 2))})
    assert sess.count == 3 and sess.clock == 1
    rows = sess.ingest({"theta": torch.ones((2, 2))}, client_ids=["c", "e"])
    assert rows.tolist() == [2, 3] and sess.count == 4
    assert sess.clients == {"a": 0, "b": 1, "c": 2, "e": 3}


def test_drift_falls_back_to_row_scale_when_inertia_is_zero():
    sess = AggregationSession(8, sketch_dim=3, device=CPU)
    pts = np.eye(3, dtype=np.float32)
    sess.ingest(sketches=pts)
    sess.finalize(k=3)
    assert sess.served_round.finalized_d2 == 0.0
    sess.route(pts + 1.0)
    scale = sess.served_round.finalized_scale
    # every routed row lies at d^2 = 3 from its nearest center
    np.testing.assert_allclose(sess.drift, 3.0 / scale, rtol=1e-6)


def test_compact_labels_skips_empty_clusters():
    labels, uniq, first = compact_labels(torch.tensor([5, 2, 5, 7],
                                                      dtype=torch.int32))
    assert labels.tolist() == [1, 0, 1, 2]
    assert uniq.tolist() == [2, 5, 7] and first.tolist() == [1, 0, 3]


def test_simulate_recovers_staggered_clusters_with_own_randomness():
    out = simulate(clients=1024, clusters=8, wave=400, route_probes=32,
                   finalize_repeats=2, device=CPU)
    assert out["purity"] == 1.0 and out["n_clusters_recovered"] == 8
    sv = out["serving"]
    assert sv["route_purity"] == 1.0 and sv["route_single_purity"] == 1.0
    assert sv["route_single_vs_batch"] == 1.0
    # the first finalize is reported alone; the warm repeat is the p50
    assert sv["finalize_warm_count"] == 1 and sv["finalize_first_ms"] > 0
    assert out["mse"] < 1e-2 and out["meta"]["n_iter"] >= 1
    hists = out["obs"]["histograms"]
    for span in ("session.ingest.ms", "session.finalize.ms",
                 "session.finalize.cluster.execute.ms",
                 "session.finalize.mean.execute.ms", "session.route.ms"):
        assert hists[span]["count"] >= 1


def test_registries_round_trip():
    from repro_torch.core.clustering import api
    from repro_torch.core.engine import aggregators

    assert "kmeans-device" in api.list_algorithms()
    twin = api.DeviceLloydFamily(name="kmeans-device-twin")
    api.register_algorithm(twin)
    try:
        assert api.get_algorithm("kmeans-device-twin") is twin
        with pytest.raises(ValueError, match="already registered"):
            api.register_algorithm(twin)
    finally:
        api.unregister_algorithm("kmeans-device-twin")
    with pytest.raises(KeyError, match="unknown algorithm"):
        api.get_algorithm("kmeans-device-twin")
    assert aggregators.list_aggregators() == ("mean",)
    copy = aggregators.MeanAggregator(name="mean-copy")
    aggregators.register_aggregator(copy)
    try:
        assert aggregators.get_aggregator("mean-copy") is copy
    finally:
        aggregators.unregister_aggregator("mean-copy")
    with pytest.raises(KeyError, match="unknown aggregator"):
        aggregators.get_aggregator("mean-copy")


@pytest.mark.parametrize("seed,m,k", [(0, 1, 1), (1, 50, 3), (2, 4096, 8),
                                      (3, 300, 40)])
def test_compact_labels_matches_np_unique(seed, m, k):
    raw = np.random.default_rng(seed).integers(0, k, size=m) * 3
    labels, uniq, first = compact_labels(torch.from_numpy(raw))
    want_uniq, want_first, want_labels = np.unique(
        raw, return_index=True, return_inverse=True)
    np.testing.assert_array_equal(labels, want_labels)
    np.testing.assert_array_equal(uniq, want_uniq)
    np.testing.assert_array_equal(first, want_first)
