"""The port's mutable session against the reference's, on the CPU.

The counterparts of ``tests/test_session_mutation.py``, run on both
packages with the same inputs: client parameters made with numpy, the
reference's JL projection carried across (``ref_projection``), and the
reference's kmeans++ centers carried across as the port's warm start
(``init="warm"`` with ``init_centers``), since the port draws from its
own generators.  Partitions, survivor sets and buffer rows must be
identical; floats agree within rtol 1e-5 (atol 1e-5 on values of order
one); the exp-decay staleness weights within rtol 1e-12.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.clustering.kmeans import kmeans_plus_plus_init as jkmeanspp
from repro.core.engine import AggregationSession as JSession
from repro.core.engine.staleness import make_staleness_policy as jmake_policy
from repro_torch import runtime
from repro_torch.core.engine import aggregators
from repro_torch.core.engine.device_convex import device_convex_cluster
from repro_torch.core.engine.session import AggregationSession
from repro_torch.core.engine.staleness import (
    ExpDecay,
    NoStaleness,
    SlidingWindow,
    make_staleness_policy,
)
from repro_torch.core.sketch import make_generator
from repro_torch.interop import centers_from_numpy, projection_from_numpy

from conftest import same_partition
from test_session import make_blobs
from test_torch_sketch import ref_projection

CPU = "cpu"


def tsession(capacity, d, *, sketch_dim=16, seed=0, **kw):
    proj = projection_from_numpy(ref_projection(seed, d, sketch_dim), CPU)
    return AggregationSession(capacity, sketch_dim=sketch_dim, seed=seed,
                              projection=proj, device=CPU, **kw)


def both(capacity, d, *, sketch_dim=16, seed=0, staleness="none"):
    """A reference and a port session of the same shape and seeds."""
    return (JSession(capacity, sketch_dim=sketch_dim, seed=seed,
                     staleness=jmake_policy(staleness)),
            tsession(capacity, d, sketch_dim=sketch_dim, seed=seed,
                     staleness=staleness))


def ingest_both(pair, values, ids):
    j, t = pair
    jrows = j.ingest({"theta": jnp.asarray(values)}, client_ids=ids)
    trows = t.ingest({"theta": torch.from_numpy(values)}, client_ids=ids)
    np.testing.assert_array_equal(trows, jrows)
    return trows


def keyed_pair(pts, **kw):
    pair = both(len(pts), pts.shape[1], **kw)
    ingest_both(pair, pts, list(range(len(pts))))
    return pair


def finalize_both(pair, k, **kw):
    """The reference finalizes with its own kmeans++ draws; the port
    starts from those same centers."""
    j, t = pair
    c0 = np.asarray(jkmeanspp(jax.random.PRNGKey(j.cluster_seed),
                              j.sketches, k))
    want = j.finalize(algorithm="kmeans-device", k=k,
                      algo_options={"init": "kmeans++"}, **kw)
    got = t.finalize(algorithm="kmeans-device", k=k,
                     algo_options={"init": "warm",
                                   "init_centers": centers_from_numpy(c0,
                                                                      CPU)},
                     **kw)
    return want, got


def assert_same_round(want, got):
    (jstate, jlabels, jinfo), (tstate, tlabels, tinfo) = want, got
    np.testing.assert_array_equal(tlabels, jlabels)
    assert tinfo["n_clusters"] == jinfo["n_clusters"]
    assert tinfo["count"] == jinfo["count"]
    assert tinfo["meta"]["n_iter"] == jinfo["meta"]["n_iter"]
    if jstate is not None:
        np.testing.assert_allclose(tstate.params["theta"].numpy(),
                                   np.asarray(jstate.params["theta"]),
                                   rtol=1e-5, atol=1e-5)


# ------------------------------------------------- keyed slots / re-upload

def test_reupload_replaces_in_place():
    pts, _ = make_blobs(0, [6, 6], 5)
    pair = keyed_pair(pts)
    rows = ingest_both(pair, pts[:3] + 1.0, [0, 1, 2])
    np.testing.assert_array_equal(rows, [0, 1, 2])
    j, t = pair
    assert t.count == j.count == len(pts)
    np.testing.assert_allclose(t.state().params["theta"][:3].numpy(),
                               pts[:3] + 1.0, rtol=1e-6)
    np.testing.assert_allclose(t.sketches.numpy(), np.asarray(j.sketches),
                               rtol=1e-5, atol=1e-5)


def test_reupload_finalize_matches_fresh_session_and_reference():
    pts, _ = make_blobs(3, [8, 8], 6)
    pair = keyed_pair(pts, sketch_dim=24, seed=5)
    moved = pts[4:10] + 0.5
    ingest_both(pair, moved, list(range(4, 10)))
    final = pts.copy()
    final[4:10] = moved
    fresh = keyed_pair(final, sketch_dim=24, seed=5)
    want, got = finalize_both(pair, 2)
    assert_same_round(want, got)
    _, fresh_got = finalize_both(fresh, 2)
    np.testing.assert_array_equal(got[1], fresh_got[1])
    assert torch.equal(got[0].params["theta"], fresh_got[0].params["theta"])


def test_duplicate_ids_within_wave_rejected():
    pts, _ = make_blobs(1, [4], 5)
    sess = tsession(8, 5)
    with pytest.raises(ValueError, match="duplicate client ids"):
        sess.ingest({"theta": torch.from_numpy(pts)}, client_ids=[0, 1, 1, 2])
    assert sess.count == 0 and sess.clock == 0


def test_new_ids_reuse_evicted_rows_before_growing():
    pts, _ = make_blobs(2, [4], 5)
    pair = both(4, 5, staleness="max_age=1")
    ingest_both(pair, pts, ["a", "b", "c", "d"])
    ingest_both(pair, pts[:1], ["a"])
    ingest_both(pair, pts[:1], ["a"])
    j, t = pair
    # b, c and d aged out: their rows are free again, so two joiners fit
    # in a buffer of 4 that four ids have already passed through
    assert t.count == j.count == 1
    rows = ingest_both(pair, pts[:2], ["e", "f"])
    assert set(rows.tolist()) <= {1, 2, 3}
    assert t.count == j.count == 3
    assert t.clients == j.clients
    with pytest.raises(ValueError, match="capacity"):
        t.ingest({"theta": torch.from_numpy(pts[:2])},
                 client_ids=["g", "h"])
    assert t.count == 3 and t.clients == j.clients


def test_anonymous_waves_take_free_rows_like_the_reference():
    pts, _ = make_blobs(4, [10], 3)
    pair = both(10, 3, staleness="max_age=2")
    j, t = pair
    for lo, hi in [(0, 4), (4, 7), (7, 9), (9, 10)]:
        ingest_both(pair, pts[lo:hi], None)
    offsets = [(j.ingest({"theta": jnp.asarray(pts[:3])}),
                t.ingest({"theta": torch.from_numpy(pts[:3])}))
               for _ in range(3)]
    assert [a for a, _ in offsets] == [b for _, b in offsets]
    assert t.count == j.count
    np.testing.assert_array_equal(t._live_rows(), j._live_rows())
    assert t._free == j._free


# ------------------------------------------------------------- staleness

def test_make_staleness_policy_parses_cli_spellings():
    assert isinstance(make_staleness_policy("none"), NoStaleness)
    assert isinstance(make_staleness_policy(None), NoStaleness)
    assert make_staleness_policy("max_age=3") == SlidingWindow(3)
    assert make_staleness_policy("sliding_window=5") == SlidingWindow(5)
    assert make_staleness_policy("exp_decay=2.0") == ExpDecay(2.0)
    assert make_staleness_policy("max_age", max_age=6) == SlidingWindow(6)
    p = SlidingWindow(7)
    assert make_staleness_policy(p) is p
    with pytest.raises(ValueError, match="unknown staleness policy"):
        make_staleness_policy("lru")


@pytest.mark.parametrize("spec", ["max_age=3.5", "max_age=x", "max_age=0",
                                  "max_age=-2", "exp_decay=x", "exp_decay=0",
                                  "exp_decay=-1.5"])
def test_make_staleness_policy_rejects_bad_specs(spec):
    with pytest.raises(ValueError, match="invalid staleness spec") as ei:
        make_staleness_policy(spec)
    assert spec in str(ei.value)


@pytest.mark.parametrize("spec", ["none", "max_age=1", "max_age=4",
                                  "exp_decay=0.5", "exp_decay=3.0"])
def test_policies_match_the_reference(spec):
    ages = np.array([0, 1, 2, 3, 4, 7, 30])
    mine, ref = make_staleness_policy(spec), jmake_policy(spec)
    np.testing.assert_array_equal(mine.evict(ages), ref.evict(ages))
    w, rw = mine.weights(ages), ref.weights(ages)
    assert (w is None) == (rw is None)
    if w is not None:
        np.testing.assert_allclose(w, rw, rtol=1e-12)


def test_sliding_window_survivors_and_finalize_match_reference():
    pts, _ = make_blobs(4, [6, 6], 6)
    pair = both(len(pts), 6, sketch_dim=24, seed=7, staleness="max_age=1")
    ingest_both(pair, pts[:6], list(range(6)))
    ingest_both(pair, pts[6:], list(range(6, 12)))
    ingest_both(pair, pts[6:], list(range(6, 12)))
    j, t = pair
    # the first wave is now age 2 > max_age=1
    assert t.count == j.count == 6
    assert set(t.clients) == set(j.clients) == set(range(6, 12))
    want, got = finalize_both(pair, 2)
    assert_same_round(want, got)
    assert got[1].shape == (6,)
    # rows 0..5 are holes: the gathered live rows finalize as a fresh
    # session of the survivors alone
    fresh = keyed_pair(pts[6:], sketch_dim=24, seed=7)
    _, fresh_got = finalize_both(fresh, 2)
    np.testing.assert_array_equal(got[1], fresh_got[1])
    assert torch.equal(got[0].params["theta"], fresh_got[0].params["theta"])


def test_snapshot_gathers_live_rows_and_stays_a_clone():
    pts, _ = make_blobs(5, [5, 5], 4)
    t = tsession(10, 4, staleness="max_age=1")
    t.ingest({"theta": torch.from_numpy(pts[:5])}, client_ids=range(5))
    t.ingest({"theta": torch.from_numpy(pts[5:])}, client_ids=range(5, 10))
    t.ingest({"theta": torch.from_numpy(pts[7:])}, client_ids=range(7, 10))
    snap = t.snapshot()
    assert snap.count == 5 and snap.clock == 3
    np.testing.assert_array_equal(t._live_rows(), [5, 6, 7, 8, 9])
    np.testing.assert_allclose(snap.params["theta"].numpy(), pts[5:])
    assert torch.equal(snap.sketches, t.sketches)
    before = snap.sketches.clone()
    # a later wave rewrites rows in place; the snapshot keeps its values
    t.ingest({"theta": torch.from_numpy(pts[5:] + 9.0)},
             client_ids=range(5, 10))
    assert torch.equal(snap.sketches, before)
    assert snap.weights is None
    # a contiguous live prefix is cloned, not viewed
    whole = tsession(4, 4)
    whole.ingest({"theta": torch.from_numpy(pts[:4])}, client_ids=range(4))
    s2 = whole.snapshot()
    kept = s2.sketches.clone()
    whole.ingest({"theta": torch.from_numpy(pts[:4] + 1.0)},
                 client_ids=range(4))
    assert torch.equal(s2.sketches, kept)
    assert not torch.equal(whole.sketches, kept)


def test_exp_decay_weights_and_mean_match_reference():
    pts, _ = make_blobs(6, [6, 6], 5)
    pair = both(16, 5, sketch_dim=16, seed=1, staleness="exp_decay=1.5")
    ingest_both(pair, pts[:4], [0, 1, 6, 7])
    ingest_both(pair, pts[4:8] + 0.3, [2, 3, 8, 9])
    ingest_both(pair, pts[8:], [4, 5, 10, 11])
    ingest_both(pair, pts[:2] - 0.2, [0, 1])
    j, t = pair
    jsnap, tsnap = j.snapshot(), t.snapshot()
    np.testing.assert_allclose(tsnap.weights, jsnap.weights, rtol=1e-12)
    assert len(set(np.round(tsnap.weights, 6))) == 4
    want, got = finalize_both(pair, 2)
    assert_same_round(want, got)
    # the weighted mean is not the plain one
    plain = keyed_pair(pts, sketch_dim=16, seed=1)
    assert not np.allclose(finalize_both(plain, 2)[1][0].params["theta"],
                           got[0].params["theta"])


def test_exp_decay_weights_fade_stale_rows():
    base = np.array([[10.0, 0.0], [-10.0, 0.0]], np.float32)
    stale = base + np.array([2.0, 0.0], np.float32)
    t = tsession(4, 2, sketch_dim=8, staleness=ExpDecay(half_life=0.1))
    t.ingest({"theta": torch.from_numpy(stale)}, client_ids=["s0", "s1"])
    for _ in range(8):
        t.ingest({"theta": torch.from_numpy(base)}, client_ids=["f0", "f1"])
    state, labels, info = t.finalize(algorithm="kmeans-device", k=2)
    assert info["n_clusters"] == 2
    assert same_partition(labels, [0, 1, 0, 1])
    np.testing.assert_allclose(state.params["theta"][2:].numpy(), base,
                               atol=1e-2)


def test_exp_decay_requires_mean_aggregator():
    pts, _ = make_blobs(5, [4, 4], 5)
    t = tsession(len(pts), 5, staleness=ExpDecay(half_life=1.0))
    t.ingest({"theta": torch.from_numpy(pts)}, client_ids=range(len(pts)))
    other = aggregators.MeanAggregator(name="mean-copy")
    with pytest.raises(ValueError, match="'mean' aggregator"):
        t.finalize(algorithm="kmeans-device", k=2, aggregator=other)
    t.finalize(algorithm="kmeans-device", k=2)


# ------------------------------------------------- warm-start re-finalize

def test_refinalize_warm_agrees_with_cold_and_the_reference():
    pts, _ = make_blobs(8, [10, 10, 10], 8, sep=6.0, noise=1.0)
    pair = keyed_pair(pts, sketch_dim=24, seed=3)
    want0, got0 = finalize_both(pair, 3)
    assert_same_round(want0, got0)
    assert got0[2]["refinalize"] is None
    j, t = pair
    want1, got1 = j.refinalize(), t.refinalize()
    assert got1[2]["refinalize"] == want1[2]["refinalize"] == "warm"
    np.testing.assert_array_equal(got1[1], got0[1])
    assert_same_round(want1, got1)
    assert got1[2]["meta"]["n_iter"] <= got0[2]["meta"]["n_iter"]
    assert got1[2]["meta"]["n_iter"] <= 2       # restart at the fixed point
    assert t.finalize_config["algorithm"] == "kmeans-device"
    assert t.finalize_config["k"] == 3
    assert t.n_clusters == 3 and tuple(t.route_centers.shape) == (3, 24)


def test_refinalize_after_mutation_matches_reference():
    pts, _ = make_blobs(9, [12, 12], 6, sep=8.0, noise=1.0)
    pair = keyed_pair(pts, sketch_dim=16, seed=2)
    finalize_both(pair, 2)
    ingest_both(pair, pts[::3] + 0.7, list(range(0, len(pts), 3)))
    j, t = pair
    want, got = j.refinalize(), t.refinalize()
    assert got[2]["refinalize"] == "warm"
    assert_same_round(want, got)
    assert got[2]["snapshot_clock"] == want[2]["snapshot_clock"] == 2


def test_refinalize_needs_prior_finalize():
    pts, _ = make_blobs(9, [4], 5)
    t = tsession(len(pts), 5)
    t.ingest({"theta": torch.from_numpy(pts)}, client_ids=range(len(pts)))
    with pytest.raises(ValueError, match="prior finalize"):
        t.refinalize()
    assert t.finalize_config is None
    with pytest.raises(ValueError, match="finalize"):
        t.n_clusters


def test_device_convex_warm_dual_converges_faster():
    pts, _ = make_blobs(7, [6, 6], 4, sep=40.0, noise=0.05)
    a = torch.from_numpy(pts)
    cold = device_convex_cluster(make_generator(0, CPU), a, lam=5e-3,
                                 iters=200)
    assert cold.nu is not None
    warm = device_convex_cluster(make_generator(0, CPU), a, lam=5e-3,
                                 iters=200, warm_nu=cold.nu)
    assert torch.equal(warm.labels, cold.labels)
    assert int(warm.n_iter) < int(cold.n_iter)


def test_convex_warm_and_cold_fallback_match_reference():
    pts, _ = make_blobs(10, [5, 5], 4, sep=40.0, noise=0.05)
    pair = both(len(pts) + 1, 4, sketch_dim=8, seed=1)
    ingest_both(pair, pts, list(range(len(pts))))
    j, t = pair
    opts = {"lam": 5e-3, "iters": 150}
    want0 = j.finalize(algorithm="convex-device", algo_options=opts)
    got0 = t.finalize(algorithm="convex-device", algo_options=opts)
    np.testing.assert_array_equal(got0[1], want0[1])
    want1, got1 = j.refinalize(), t.refinalize()
    assert got1[2]["refinalize"] == want1[2]["refinalize"] == "warm"
    np.testing.assert_array_equal(got1[1], want1[1])
    np.testing.assert_array_equal(got1[1], got0[1])
    assert got1[2]["meta"]["n_iter"] < got0[2]["meta"]["n_iter"]
    # the AMA dual is per edge: a changed client count invalidates it
    ingest_both(pair, pts[:1] + 9.0, ["new"])
    want2, got2 = j.refinalize(), t.refinalize()
    assert got2[2]["refinalize"] == want2[2]["refinalize"] == "cold"
    np.testing.assert_array_equal(got2[1], want2[1])


# ------------------------------------------------- drift / maybe_refinalize

def test_maybe_refinalize_triggers_on_drift():
    pts, _ = make_blobs(11, [12, 12], 8)
    pair = keyed_pair(pts, sketch_dim=24, seed=2)
    finalize_both(pair, 2)
    j, t = pair
    j.route(j.sketch_params({"theta": jnp.asarray(pts)}))
    t.route(t.sketch_params({"theta": torch.from_numpy(pts)}))
    np.testing.assert_allclose(t.drift, j.drift, rtol=1e-5)
    assert t.drift < 1.5
    assert t.maybe_refinalize(threshold=1.5) is None
    far = pts[:6] + 80.0
    j.route(j.sketch_params({"theta": jnp.asarray(far)}))
    t.route(t.sketch_params({"theta": torch.from_numpy(far)}))
    np.testing.assert_allclose(t.drift, j.drift, rtol=1e-5)
    assert t.drift > 1.5
    want, got = j.maybe_refinalize(threshold=1.5), t.maybe_refinalize(
        threshold=1.5)
    assert got is not None and got[2]["refinalize"] == "warm"
    np.testing.assert_array_equal(got[1], want[1])
    assert t.drift is None                 # gauge re-anchored


def test_drift_degenerate_zero_inertia_uses_scale_fallback():
    pts = np.ones((6, 5), np.float32) * 3.0
    j = JSession(6, sketch_dim=8, seed=0)
    t = tsession(6, 5, sketch_dim=8)
    j.ingest({"theta": jnp.asarray(pts)})
    t.ingest({"theta": torch.from_numpy(pts)})
    j.finalize(algorithm="kmeans-device", k=1)
    t.finalize(algorithm="kmeans-device", k=1)
    j.route(params={"theta": jnp.asarray(pts[0])})
    t.route(params={"theta": torch.from_numpy(pts[0])})
    # both gauges read "no drift"; their values are ratios of rounding
    # residues (~1e-13) and are not compared with each other
    assert t.drift is not None and t.drift < 10.0
    assert j.drift < 10.0


# ------------------------------------------------- engines / atomicity

def test_engine_host_is_not_ported_yet():
    # engine="host" is ported now: the host family runs, with the device
    # round's partition
    pts, _ = make_blobs(12, [8, 8], 6)
    t = tsession(len(pts), 6)
    t.ingest({"theta": torch.from_numpy(pts)}, client_ids=range(len(pts)))
    _, host_labels, host_info = t.finalize(algorithm="kmeans-device", k=2,
                                           engine="host")
    assert host_info["engine"] == "host"
    _, dev_labels, _ = t.finalize(algorithm="kmeans-device", k=2)
    assert same_partition(host_labels, dev_labels)
    with pytest.raises(ValueError, match="auto\\|host\\|device"):
        t.finalize(algorithm="kmeans-device", k=2, engine="tpu")
    _, labels, info = t.finalize(algorithm="kmeans-device", k=2,
                                 engine="auto")
    assert info["engine"] == "device" and labels.shape == (len(pts),)


def test_rejected_wave_leaves_state_untouched():
    pts, _ = make_blobs(14, [6, 6], 5)
    t = tsession(len(pts), 5, seed=6)
    t.ingest({"theta": torch.from_numpy(pts)}, client_ids=range(len(pts)))
    t.finalize(algorithm="kmeans-device", k=2)
    clients, clock, served = t.clients, t.clock, t.served_round
    with pytest.raises(ValueError, match="does not match the session's"):
        t.ingest({"theta": torch.zeros((3, 99))}, client_ids=[0, 1, 2])
    with pytest.raises(ValueError, match="capacity"):
        t.ingest({"theta": torch.zeros((3, 5))}, client_ids=["x", "y", "z"])
    assert t.count == len(pts) and t.clients == clients
    assert t.clock == clock and t.served_round is served
    cid = t.route(params={"theta": torch.from_numpy(pts[0])})
    assert 0 <= cid < t.n_clusters


def test_cluster_model_bounds_check():
    pts, _ = make_blobs(15, [6, 6], 5)
    t = tsession(len(pts), 5)
    t.ingest({"theta": torch.from_numpy(pts)}, client_ids=range(len(pts)))
    t.finalize(algorithm="kmeans-device", k=2)
    t.cluster_model(0)
    t.cluster_model(t.n_clusters - 1)
    with pytest.raises(IndexError, match="out of range"):
        t.cluster_model(-1)
    with pytest.raises(IndexError, match="out of range"):
        t.cluster_model(t.n_clusters)


# ------------------------------------------------- route host-sync budget

def test_route_batch_is_a_single_host_sync(monkeypatch):
    """A batched route crosses to the host once: labels and the drift
    accumulator ride one transfer."""
    pts, _ = make_blobs(0, [8, 8], 6)
    t = tsession(len(pts), 6)
    t.ingest({"theta": torch.from_numpy(pts)}, client_ids=range(len(pts)))
    t.finalize(k=2)
    sk = t.sketch_params({"theta": torch.from_numpy(pts)}).numpy()
    calls = []
    for name in ("cpu", "item", "tolist", "numpy", "__float__", "__int__",
                 "__bool__"):
        real = getattr(torch.Tensor, name)

        def spy(self, *a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, spy)
    t.route(sk)
    assert calls.count("cpu") == 1 and set(calls) <= {"cpu", "numpy"}
    calls.clear()
    t.route(sk[0])
    assert calls.count("cpu") == 1 and set(calls) <= {"cpu", "numpy"}
    assert t.drift is not None


# ------------------------------------------------- hypothesis property

from hypothesis import given, settings, strategies as st  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One host thread: the tensors here are small, and parallel test
    workers must not oversubscribe the CPU."""
    with runtime.pinned_threads(1):
        yield


@st.composite
def mutation_scripts(draw):
    """An initial keyed federation plus a random script of keyed
    re-upload waves (subsets of the ids, shifted values)."""
    n = draw(st.integers(4, 10))
    waves = []
    for _ in range(draw(st.integers(1, 4))):
        size = draw(st.integers(1, n))
        ids = draw(st.lists(st.integers(0, n - 1), min_size=size,
                            max_size=size, unique=True))
        shift = draw(st.floats(-4.0, 4.0, allow_nan=False))
        waves.append((sorted(ids), shift))
    return n, waves


@settings(max_examples=12, deadline=None)
@given(mutation_scripts())
def test_arbitrary_reuploads_match_fresh_session_and_reference(script):
    n, waves = script
    pts, _ = make_blobs(42, [n - n // 2, n // 2], 6)
    pair = keyed_pair(pts, sketch_dim=16, seed=9)
    final = pts.copy()
    for ids, shift in waves:
        vals = pts[ids] + np.float32(shift)
        ingest_both(pair, vals, ids)
        final[ids] = vals
    assert pair[1].count == pair[0].count == n
    want, got = finalize_both(pair, 2)
    # port against port: bit-exact with a fresh session of the values
    fresh = keyed_pair(final, sketch_dim=16, seed=9)
    _, fresh_got = finalize_both(fresh, 2)
    np.testing.assert_array_equal(got[1], fresh_got[1])
    assert torch.equal(got[0].params["theta"], fresh_got[0].params["theta"])
    # then against the reference
    assert_same_round(want, got)


# ------------------------------------------------- simulate

def test_simulate_mutation_loop_matches_reference_slot_counts():
    """The mutation loop of ``simulate`` keeps the same live set as the
    reference's on the same configuration (the counts depend only on the
    slot bookkeeping, not on the drawn data), recovers the clusters, and
    fires the drift-triggered warm re-finalize."""
    from repro.launch.simulate import simulate as jsimulate
    from repro_torch.launch.simulate import simulate

    kw = dict(clients=1024, clusters=8, wave=256, reupload_frac=0.25,
              churn=16, max_age=3, refinalize_threshold=1.5)
    want = jsimulate(**kw)["serving"]
    out = simulate(**kw, finalize_repeats=2, qps_callers=2,
                   qps_duration=0.2, device=CPU)
    sv = out["serving"]
    assert out["purity"] == 1.0
    assert sv["live_clients"] == want["live_clients"] == 544
    assert sv["evictions"] == want["evictions"] == 1040
    assert sv["refinalize_fired"] is want["refinalize_fired"] is True
    assert sv["refinalize_count"] == 2
    assert sv["refinalize_warm_p50_ms"] > 0
    assert sv["drift_after_mutation"] > 1.5
    qs = out["qps_server"]
    assert qs["errors"] == 0 and qs["timeouts"] == 0
    assert qs["batched_qps"] > 0 and qs["direct_qps"] > 0
