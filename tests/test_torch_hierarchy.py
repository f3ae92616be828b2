"""The port's two-level hierarchical round against the reference's, on the
CPU (the counterparts of ``tests/test_hierarchy.py``).

``shards=1`` delegates to the flat session: bit-exact with the port's
flat round, and (the reference's kmeans++ seeds carried across as the
port's ``init="warm"``) the reference's labels.  At S = 2 and 4 on
well-separated blobs each package recovers the planted partition, so
the labels agree up to renaming and the models within rtol 1e-5 (atol
1e-5 of the largest |theta|); the per-level byte counts are the
reference's.  An MoE federation (``cfg.is_moe``) sketches only
its router-invariant leaves in every shard session, as the reference's
does.  Then the guards, the convex family through the
hierarchy, and a scenario's sketch hook at S > 1, whose rows equal the
flat session's (the port keys shards by global row; the reference does
not, ROADMAP queue C): for waves that straddle a shard edge too under
the spoof, which is keyed by row, while the DP noise, keyed by the
offset of each wave piece a shard receives, equals the flat session's
only when the flat session is fed the same pieces.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.clustering.kmeans import kmeans_plus_plus_init as jkmeanspp
from repro.core.engine import HierarchicalSession as JHier
from repro.core.engine import hierarchical_one_shot_aggregate as jhier_round
from repro.core.federated import FederatedState as JState
from repro_torch import runtime
from repro_torch.core.engine.hierarchy import (
    HierarchicalSession,
    hierarchical_one_shot_aggregate,
)
from repro_torch.core.engine.session import AggregationSession
from repro_torch.interop import (
    centers_from_numpy,
    projection_from_numpy,
    state_from_numpy,
)
from repro_torch.scenarios import ByzantineScenario, DPScenario
from repro_torch.utils import prng, tree_leaves

from conftest import same_partition
from test_session import blob_state, make_blobs
from test_torch_sketch import ref_projection
from test_torch_train_step import assert_tree_close


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One host thread: the tensors here are small, and parallel test
    workers must not oversubscribe the CPU."""
    with runtime.pinned_threads(1):
        yield


CPU = "cpu"


def proj(seed, d, s):
    return projection_from_numpy(ref_projection(seed, d, s), CPU)


def thier(n, d, *, shards, sketch_dim, seed=0, **kw):
    return HierarchicalSession(n, shards=shards, sketch_dim=sketch_dim,
                               seed=seed, projection=proj(seed, d,
                                                          sketch_dim),
                               device=CPU, **kw)


def ingest_pattern(sess, pts, pattern):
    off, i = 0, 0
    while off < len(pts):
        w = min(pattern[i % len(pattern)], len(pts) - off)
        sess.ingest({"theta": torch.from_numpy(pts[off:off + w])})
        off += w
        i += 1
    return sess


# ----------------------------------------------- S=1: the flat round

@pytest.mark.parametrize("seed,sizes,d", [
    (0, [9, 7, 11], 8), (3, [5, 5], 4), (11, [8, 3, 6, 7], 12),
    (5, [4, 9, 2], 6), (8, [6, 6, 6, 6], 10)])
def test_shards_1_bit_exact_with_flat_round(seed, sizes, d):
    pts, _ = make_blobs(seed, sizes, d)
    k, s = len(sizes), 32
    flat = AggregationSession(len(pts), sketch_dim=s, seed=3,
                              projection=proj(3, d, s), device=CPU)
    flat.ingest({"theta": torch.from_numpy(pts)})
    want_state, want_labels, _ = flat.finalize(k=k)
    state, labels, info = hierarchical_one_shot_aggregate(
        state_from_numpy({"theta": pts}, CPU), shards=1, k=k, sketch_dim=s,
        seed=3, projection=proj(3, d, s), device=CPU)
    np.testing.assert_array_equal(labels, want_labels)
    assert torch.equal(state.params["theta"], want_state.params["theta"])
    assert info["shards"] == 1


@pytest.mark.parametrize("seed,sizes,d", [
    (0, [9, 7, 11], 8), (3, [5, 5], 4), (11, [8, 3, 6, 7], 12)])
def test_shards_1_labels_equal_reference(seed, sizes, d):
    """The reference's own kmeans++ seeds handed to the port as a warm
    start: the same labels, models within rtol 1e-5."""
    pts, _ = make_blobs(seed, sizes, d)
    k, s = len(sizes), 32
    jstate, jlabels, _ = jhier_round(blob_state(pts), shards=1, k=k,
                                     sketch_dim=s, seed=3)
    jsess = JHier(len(pts), shards=1, sketch_dim=s, seed=3)
    jsess.ingest({"theta": jnp.asarray(pts)})
    c0 = np.asarray(jkmeanspp(jax.random.PRNGKey(3), jsess.sketches, k))
    state, labels, _ = hierarchical_one_shot_aggregate(
        state_from_numpy({"theta": pts}, CPU), shards=1, k=k, sketch_dim=s,
        seed=3, projection=proj(3, d, s), device=CPU,
        algo_options={"init": "warm",
                      "init_centers": centers_from_numpy(c0, CPU)})
    np.testing.assert_array_equal(labels, jlabels)
    np.testing.assert_allclose(state.params["theta"].numpy(),
                               np.asarray(jstate.params["theta"]),
                               rtol=1e-5, atol=1e-5)


# -------------------------------------------------- sharded composition

@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_round_matches_reference(shards):
    pts, true = make_blobs(2, [30, 25, 35], 6, sep=40.0, noise=0.05)
    perm = np.random.default_rng(shards).permutation(len(pts))
    pts, true = pts[perm], true[perm]
    jstate, jlabels, jinfo = jhier_round(blob_state(pts), shards=shards, k=3,
                                         sketch_dim=24, seed=0)
    state, labels, info = hierarchical_one_shot_aggregate(
        state_from_numpy({"theta": pts}, CPU), shards=shards, k=3,
        sketch_dim=24, seed=0, projection=proj(0, 6, 24), device=CPU)
    assert same_partition(labels, jlabels) and same_partition(labels, true)
    assert info["shards"] == jinfo["shards"] == shards
    assert info["n_clusters"] == jinfo["n_clusters"] == 3
    assert info["per_shard_clusters"] == jinfo["per_shard_clusters"]
    assert info["comm_level_bytes"] == jinfo["comm_level_bytes"]
    scale = float(np.abs(pts).max())
    np.testing.assert_allclose(state.params["theta"].numpy(),
                               np.asarray(jstate.params["theta"]),
                               rtol=1e-5, atol=1e-5 * scale)
    # the composed models are the exact global per-cluster means
    served = state.params["theta"].numpy()
    for c in np.unique(labels):
        want = np.broadcast_to(pts[labels == c].mean(axis=0),
                               served[labels == c].shape)
        np.testing.assert_allclose(served[labels == c], want, rtol=1e-4,
                                   atol=1e-4)


MOE_CFG = SimpleNamespace(is_moe=True)


def moe_federation(seed, c=8):
    """A planted MoE-shaped federation: the dense path and the router of
    clients 0..c/2-1 near one model, of the others near another; the
    per-expert ``moe/w_in`` and ``moe/w_out`` drawn for each client at
    ten times the scale, so only the router-invariant sketch sees the
    plant.  The clients are shuffled across the shards."""
    rng = np.random.default_rng(seed)
    shapes = {"attn": {"wq": (4, 6)}, "moe": {"router": (4, 3),
                                            "w_in": (3, 4, 5),
                                            "w_out": (3, 5, 4)}}
    truth = rng.permutation(np.arange(c) % 2)

    def leaf(shape, expert):
        if expert:
            return 10.0 * rng.normal(size=(c,) + shape)
        centers = 3.0 * rng.normal(size=(2,) + shape)
        return centers[truth] + 0.01 * rng.normal(size=(c,) + shape)

    params = {g: {k: leaf(v, k.startswith("w_")).astype(np.float32)
                  for k, v in d.items()} for g, d in shapes.items()}
    n = 4 * 6 + 4 * 3                       # the router-invariant values
    return params, truth, n


@pytest.mark.parametrize("shards", [1, 2])
def test_moe_round_sketches_router_invariant_leaves_as_reference(shards):
    """``hierarchical_one_shot_aggregate(state, cfg, shards=)``: each shard
    session gets the config, so the projection carried across (the
    reference's for the router-invariant values alone; a session that
    sketched every leaf would refuse it) gives the reference's partition,
    the planted one, and its models; ``shards=1`` equals the flat
    round with the config bit for bit."""
    params, truth, n = moe_federation(shards)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = JState(params=jparams, opt_state=None, n_clients=len(truth))
    jnew, jlabels, _ = jhier_round(jstate, MOE_CFG, shards=shards, k=2,
                                   sketch_dim=8, seed=2)
    projection = projection_from_numpy(ref_projection(2, n, 8), CPU)
    state = state_from_numpy(params, CPU)
    new, labels, info = hierarchical_one_shot_aggregate(
        state, MOE_CFG, shards=shards, k=2, sketch_dim=8, seed=2,
        projection=projection, device=CPU)
    assert info["shards"] == shards
    assert same_partition(labels, jlabels) and same_partition(labels, truth)
    assert_tree_close(new.params, jnew.params)
    if shards == 1:
        flat = AggregationSession(len(truth), sketch_dim=8, seed=2,
                                  cfg=MOE_CFG, projection=projection,
                                  device=CPU)
        flat.ingest(state.params)
        want, want_labels, _ = flat.finalize(k=2)
        np.testing.assert_array_equal(labels, want_labels)
        for g, w in zip(tree_leaves(new.params), tree_leaves(want.params)):
            assert torch.equal(g, w)


def test_sharded_round_recovers_planted_clusters():
    pts, true = make_blobs(1, [40, 40, 40], 8)
    perm = np.random.default_rng(1).permutation(len(pts))
    state, labels, info = hierarchical_one_shot_aggregate(
        state_from_numpy({"theta": pts[perm]}, CPU), shards=4, k=3,
        sketch_dim=32, seed=0, device=CPU)
    assert info["shards"] == 4 and info["n_clusters"] == 3
    assert same_partition(labels, true[perm])


def test_sharded_ingest_split_matches_single_wave():
    pts, _ = make_blobs(3, [20, 20], 5)
    a = thier(len(pts), 5, shards=2, sketch_dim=16)
    b = thier(len(pts), 5, shards=2, sketch_dim=16)
    a.ingest({"theta": torch.from_numpy(pts)})
    ingest_pattern(b, pts, (3, 11, 6))
    assert torch.equal(a.sketches, b.sketches)
    _, lab_a, _ = a.finalize(k=2)
    _, lab_b, _ = b.finalize(k=2)
    np.testing.assert_array_equal(lab_a, lab_b)


def test_per_level_comm_accounting_equals_reference():
    pts, _ = make_blobs(4, [30, 30, 30], 6)
    sess = thier(len(pts), 6, shards=3, sketch_dim=16)
    sess.ingest({"theta": torch.from_numpy(pts)})
    _, _, info = sess.finalize(k=3)
    jsess = JHier(len(pts), shards=3, sketch_dim=16, seed=0)
    jsess.ingest({"theta": jnp.asarray(pts)})
    _, _, jinfo = jsess.finalize(k=3)
    clb = info["comm_level_bytes"]
    assert clb == jinfo["comm_level_bytes"]
    assert clb["level0"] == len(pts) * 16 * 4
    assert clb["level1"] == sum(info["per_shard_clusters"]) * (16 + 1) * 4
    assert clb["level1"] < clb["level0"]


def test_sketch_only_hierarchical_round_routes():
    pts, true = make_blobs(5, [25, 25], 6)
    flat = thier(len(pts), 6, shards=1, sketch_dim=16)
    sk = flat.sketch_params({"theta": torch.from_numpy(pts)})
    sess = thier(len(pts), 6, shards=2, sketch_dim=16)
    sess.ingest(sketches=sk)
    state, labels, _ = sess.finalize(k=2)
    assert state is None
    assert same_partition(labels, true)
    np.testing.assert_array_equal(sess.route(sk), labels)
    with pytest.raises(ValueError, match="no parameters"):
        sess.cluster_model(0)


def test_route_and_cluster_model_compose():
    pts, _ = make_blobs(6, [30, 30, 30], 8)
    sess = thier(len(pts), 8, shards=3, sketch_dim=32)
    sess.ingest({"theta": torch.from_numpy(pts)})
    state, labels, _ = sess.finalize(k=3)
    assert sess.n_clusters == 3 and sess.route_centers.shape == (3, 32)
    sk = sess.sketch_params({"theta": torch.from_numpy(pts)})
    np.testing.assert_array_equal(sess.route(sk), labels)
    assert sess.route(params={"theta": torch.from_numpy(pts[5])}) == labels[5]
    cid = int(labels[0])
    np.testing.assert_allclose(sess.cluster_model(cid)["theta"].numpy(),
                               state.params["theta"][0].numpy(), rtol=1e-6)
    with pytest.raises(IndexError):
        sess.cluster_model(3)
    assert sess.drift is None
    assert sess.state().params["theta"].shape == (90, 8)
    # the same composed labels as the reference's session
    jsess = JHier(len(pts), shards=3, sketch_dim=32, seed=0)
    jsess.ingest({"theta": jnp.asarray(pts)})
    _, jlabels, _ = jsess.finalize(k=3)
    assert same_partition(labels, jlabels)


@pytest.mark.parametrize("algorithm,options", [
    ("clusterpath-device", {"edges": "knn", "knn_k": 5, "iters": 300}),
    ("convex-device", {"edges": "knn", "knn_k": 5, "iters": 300,
                       "lam": 0.05})])
def test_convex_family_streams_through_hierarchy(algorithm, options):
    pts, true = make_blobs(7, [14, 12, 13], 6, sep=30.0, noise=0.1)
    sess = thier(len(pts), 6, shards=2, sketch_dim=24, seed=1)
    sess.ingest({"theta": torch.from_numpy(pts)})
    _, labels, info = sess.finalize(algorithm=algorithm,
                                    algo_options=options)
    assert info["n_clusters"] == 3
    assert same_partition(labels, true)
    if algorithm == "clusterpath-device":
        jsess = JHier(len(pts), shards=2, sketch_dim=24, seed=1)
        jsess.ingest({"theta": jnp.asarray(pts)})
        _, jlabels, _ = jsess.finalize(algorithm=algorithm,
                                       algo_options=options)
        assert same_partition(labels, jlabels)


# ------------------------------------------------ a scenario's sketch hook

@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("attack", ["spoof", "dp"])
def test_sketch_hook_rows_equal_flat_session(shards, attack):
    """Each shard's hook sees global rows (``row_base``), so the spoofed
    rows are the attackers of the global index and the DP noise blocks
    are the flat session's (waves that do not straddle a shard edge, as
    the DP noise is keyed by the wave's offset)."""
    n, d, s = 96, 6, 8
    pts = np.random.default_rng(shards).normal(size=(n, d)).astype(
        np.float32)
    key = prng.key(3)
    scen = (ByzantineScenario(frac=0.3, attack="spoof") if attack == "spoof"
            else DPScenario(epsilon=4.0))

    def hook(sk, off):
        return scen.sketch_transform(key, sk, off)

    flat = AggregationSession(n, sketch_dim=s, projection=proj(0, d, s),
                              sketch_transform=hook, device=CPU)
    hier = thier(n, d, shards=shards, sketch_dim=s, sketch_transform=hook)
    wave = n // shards // 2
    for sess in (flat, hier):
        ingest_pattern(sess, pts, (wave,))
    assert torch.equal(hier.sketches, flat.sketches)
    if attack == "spoof":
        bad = ~scen.honest_mask(key, n, device=CPU).numpy()
        rows = hier.sketches.numpy()
        assert np.ptp(rows[bad], axis=0).max() == 0.0
        clean = hier.sketch_params({"theta": torch.from_numpy(pts)}).numpy()
        np.testing.assert_array_equal(rows[~bad], clean[~bad])


@pytest.mark.parametrize("shards", [2, 4])
def test_straddling_wave_keys_by_global_row(shards):
    """A wave that straddles a shard edge is split there.  The spoof's
    attacker mask is keyed by the global row and its forged row is one
    shared draw, so the rows equal the flat session's fed the uncut
    waves.  The DP noise is drawn for each piece at its global offset: the
    rows equal those of a flat session fed the waves cut at the shard
    edges, and differ from those of the uncut waves."""
    n, d, s = 96, 6, 8
    cap = n // shards
    wave = cap + cap // 2                      # straddles every other edge
    pts = np.random.default_rng(10 + shards).normal(size=(n, d)).astype(
        np.float32)
    cuts = sorted(set(range(0, n, wave)) | set(range(0, n, cap)) | {n})
    pieces = np.diff(cuts)
    assert len(pieces) > len(range(0, n, wave))
    key = prng.key(5)
    for scen in (ByzantineScenario(frac=0.3, attack="spoof"),
                 DPScenario(epsilon=4.0)):
        def hook(sk, off):
            return scen.sketch_transform(key, sk, off)

        def flat(pattern):
            return ingest_pattern(
                AggregationSession(n, sketch_dim=s, projection=proj(0, d, s),
                                   sketch_transform=hook, device=CPU),
                pts, pattern).sketches

        hier = ingest_pattern(thier(n, d, shards=shards, sketch_dim=s,
                                    sketch_transform=hook), pts, (wave,))
        if scen.name == "byzantine":
            assert torch.equal(hier.sketches, flat((wave,)))
            bad = ~scen.honest_mask(key, n, device=CPU).numpy()
            rows = hier.sketches.numpy()
            assert bad.any() and np.ptp(rows[bad], axis=0).max() == 0.0
            clean = hier.sketch_params(
                {"theta": torch.from_numpy(pts)}).numpy()
            np.testing.assert_array_equal(rows[~bad], clean[~bad])
        else:
            assert torch.equal(hier.sketches, flat(tuple(pieces)))
            assert not torch.equal(hier.sketches, flat((wave,)))


# ------------------------------------------------------------ guard rails

def test_keyed_ingest_rejected():
    sess = HierarchicalSession(8, shards=2, sketch_dim=8, device=CPU)
    with pytest.raises(ValueError, match="anonymous-only"):
        sess.ingest({"theta": torch.zeros((2, 4))}, client_ids=[0, 1])
    with pytest.raises(ValueError, match="exactly one"):
        sess.ingest()


def test_capacity_and_empty_guards():
    sess = HierarchicalSession(8, shards=2, sketch_dim=8, device=CPU)
    with pytest.raises(ValueError, match="nothing ingested"):
        sess.finalize(k=2)
    with pytest.raises(ValueError, match="capacity exceeded"):
        sess.ingest({"theta": torch.zeros((9, 4))})
    with pytest.raises(ValueError, match="route"):
        HierarchicalSession(8, shards=2, sketch_dim=4, device=CPU).route(
            torch.zeros(4))
    with pytest.raises(ValueError, match="shards"):
        HierarchicalSession(4, shards=0, device=CPU)
    with pytest.raises(ValueError, match="capacity"):
        HierarchicalSession(2, shards=4, device=CPU)


def test_simulate_guards_shards_against_mutation_and_qps():
    from repro_torch.launch.simulate import simulate
    with pytest.raises(ValueError, match="shards"):
        simulate(clients=64, clusters=2, shards=2, churn=4, device=CPU)
    with pytest.raises(ValueError, match="shards"):
        simulate(clients=64, clusters=2, shards=2, max_age=3, device=CPU)
    with pytest.raises(ValueError, match="shards"):
        simulate(clients=64, clusters=2, shards=2, qps_callers=2,
                 device=CPU)


def test_simulate_shards_summary():
    from repro_torch.launch.simulate import simulate
    out = simulate(clients=1024, clusters=4, shards=4, wave=256,
                   sketch_dim=16, route_probes=8, device=CPU)
    assert out["shards"] == 4 and out["purity"] == 1.0
    assert out["n_clusters_recovered"] == 4 and out["mse"] < 1e-2
    assert out["comm_level_bytes"] == {"level0": 1024 * 16 * 4,
                                       "level1": 16 * 17 * 4}
    assert out["serving"]["route_purity"] == 1.0
    spans = out["obs"]["histograms"]
    assert spans["session.finalize.ms"]["count"] == 5      # 4 shards + top
    assert spans["hierarchy.level0.ms"]["count"] == 1
    assert spans["hierarchy.level1.ms"]["count"] == 1
