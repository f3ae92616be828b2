"""The device Lloyd loop's options against the JAX reference, on the CPU:
minibatch Lloyd (``batch_m``), robust center updates (``aggregator``) and
the trimmed objective that scores restarts.

The reference's random draws are carried across: the minibatch rows of
every iteration (``jax.random.choice(it_key, m, (batch_m,),
replace=False)`` over ``split(fold_in(key, 0x6d62), iters)``), the
``random`` init's rows and the kmeans++ start centers.  Labels and
iteration counts must be equal; centers agree within rtol 1e-5 and atol
1e-5 * max|x|.  The port's objective is held to the float64 sum over the
reference's labels and centers (rtol 1e-5), not to the reference's own
figure, which it computes by an expansion that loses digits
(ROADMAP queue C).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.clustering.kmeans import kmeans_plus_plus_init as jkmeanspp
from repro.core.engine.aggregators import make_aggregator as jmake
from repro.core.engine.device_kmeans import device_kmeans as jdevice_kmeans
from repro_torch import runtime
from repro_torch.core.clustering.api import get_algorithm, meta_to_host
from repro_torch.core.engine.aggregators import make_aggregator as tmake
from repro_torch.core.engine.device_kmeans import (
    _restart_generator,
    device_kmeans,
    trimmed_inertia,
)
from repro_torch.core.federated import cluster_agreement
from repro_torch.core.sketch import make_generator
from repro_torch.interop import centers_from_numpy, rows_from_numpy

from test_torch_engine import make_blobs


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One host thread: the tensors here are small, and parallel test
    workers must not oversubscribe the CPU."""
    with runtime.pinned_threads(1):
        yield


CPU = "cpu"


def reference_batch_rows(key, m, batch_m, iters):
    keys = jax.random.split(jax.random.fold_in(key, 0x6d62), iters)
    return [np.asarray(jax.random.choice(kk, m, (batch_m,), replace=False))
            for kk in keys]


def attacked_blobs(seed, sizes, d, frac=0.08):
    """Blobs with a fraction of rows thrown far out along one direction
    (sign-flipped and scaled, as a Byzantine upload would be)."""
    pts, truth = make_blobs(seed, sizes, d)
    rng = np.random.default_rng(seed + 100)
    bad = rng.choice(len(pts), int(frac * len(pts)), replace=False)
    pts[bad] = -4.0 * pts[bad]
    return pts, truth


def objective64(pts, labels, centers, t=0):
    d2 = np.sum((pts.astype(np.float64) - centers.astype(np.float64)[labels])
                ** 2, axis=1)
    return float(np.sum(np.sort(d2)[:len(d2) - t]))


def check_run(got, want, pts):
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert got.n_iter == int(want.n_iter)
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(want.centers),
                               rtol=1e-5, atol=1e-5 * float(np.abs(pts).max()))


MINIBATCH = [(0, [60, 50, 70, 40], 8, 64, 20), (1, [30, 90, 45], 16, 100, 12),
             (2, [100, 100, 100, 100, 100], 4, 37, 30),
             (3, [7, 5], 2, 5, 8)]


@pytest.mark.parametrize("seed,sizes,d,batch_m,iters", MINIBATCH)
def test_minibatch_lloyd_with_carried_rows(seed, sizes, d, batch_m, iters):
    pts, _ = make_blobs(seed, sizes, d)
    k, m = len(sizes), len(pts)
    key = jax.random.PRNGKey(seed)
    c0 = np.array(jkmeanspp(key, jnp.asarray(pts), k))
    want = jdevice_kmeans(key, jnp.asarray(pts), k, iters=iters, init="warm",
                          init_centers=c0, batch_m=batch_m)
    sampler = rows_from_numpy(*reference_batch_rows(key, m, batch_m, iters))
    got = device_kmeans(make_generator(seed, CPU), torch.from_numpy(pts), k,
                        iters=iters, init="warm",
                        init_centers=centers_from_numpy(c0, CPU),
                        batch_m=batch_m, sampler=sampler)
    check_run(got, want, pts)
    assert sampler.calls == got.n_iter
    np.testing.assert_allclose(
        float(got.inertia),
        objective64(pts, np.asarray(want.labels), np.asarray(want.centers)),
        rtol=1e-5)


@pytest.mark.parametrize("seed,sizes,d,batch_m,iters", MINIBATCH[:2])
def test_minibatch_lloyd_random_init_with_carried_rows(seed, sizes, d,
                                                       batch_m, iters):
    pts, _ = make_blobs(seed, sizes, d)
    k, m = len(sizes), len(pts)
    key = jax.random.PRNGKey(seed)
    init_rows = np.asarray(jax.random.choice(key, m, (k,), replace=False))
    want = jdevice_kmeans(key, jnp.asarray(pts), k, iters=iters,
                          init="random", batch_m=batch_m)
    sampler = rows_from_numpy(init_rows,
                              *reference_batch_rows(key, m, batch_m, iters))
    got = device_kmeans(make_generator(seed, CPU), torch.from_numpy(pts), k,
                        iters=iters, init="random", batch_m=batch_m,
                        sampler=sampler)
    check_run(got, want, pts)


@pytest.mark.parametrize("init", ["kmeans++", "random", "spectral"])
@pytest.mark.parametrize("extra", [0, 1, 1000])
def test_batch_at_least_m_is_the_full_loop(init, extra):
    pts, _ = make_blobs(4, [40, 30, 50], 6)
    x = torch.from_numpy(pts)

    def refuse(*_):
        raise AssertionError("the full loop draws no minibatch")

    full = device_kmeans(make_generator(5, CPU), x, 3, init=init, restarts=2)
    got = device_kmeans(make_generator(5, CPU), x, 3, init=init, restarts=2,
                        batch_m=len(pts) + extra,
                        sampler=None if init == "random" else refuse)
    assert torch.equal(got.labels, full.labels)
    assert torch.equal(got.centers, full.centers)
    assert got.n_iter == full.n_iter
    assert torch.equal(got.inertia, full.inertia)


@pytest.mark.parametrize("name", ["trimmed_mean", "median",
                                  "geometric_median"])
@pytest.mark.parametrize("seed,sizes,d", [(0, [60, 50, 70, 40], 8),
                                          (1, [30, 90, 45], 16),
                                          (2, [40, 40, 40, 40, 40], 4)])
def test_robust_lloyd_from_carried_centers(name, seed, sizes, d):
    pts, _ = attacked_blobs(seed, sizes, d)
    k, m = len(sizes), len(pts)
    key = jax.random.PRNGKey(seed)
    c0 = np.array(jkmeanspp(key, jnp.asarray(pts), k))
    want = jdevice_kmeans(key, jnp.asarray(pts), k, iters=50, init="warm",
                          init_centers=c0,
                          aggregator=jmake(name, beta=0.2))
    agg = tmake(name, beta=0.2)
    got = device_kmeans(make_generator(seed, CPU), torch.from_numpy(pts), k,
                        iters=50, init="warm",
                        init_centers=centers_from_numpy(c0, CPU),
                        aggregator=agg)
    check_run(got, want, pts)
    t = int(min(agg.breakdown, 0.45) * m)
    np.testing.assert_allclose(
        float(got.inertia),
        objective64(pts, np.asarray(want.labels), np.asarray(want.centers), t),
        rtol=1e-5)
    # the reference's own figure is the same objective, up to its expansion
    np.testing.assert_allclose(float(got.inertia), float(want.inertia),
                               rtol=1e-3)


@pytest.mark.parametrize("beta,t_of_m", [(0.1, 0.1), (0.3, 0.3),
                                         (0.49, 0.45)])
def test_trimmed_objective(beta, t_of_m):
    pts, _ = attacked_blobs(3, [50, 70, 30], 5)
    m = len(pts)
    x = torch.from_numpy(pts)
    agg = tmake("trimmed_mean", beta=beta)
    res = device_kmeans(make_generator(0, CPU), x, 3, aggregator=agg)
    t = int(t_of_m * m)
    want = objective64(pts, res.labels.numpy(), res.centers.numpy(), t)
    np.testing.assert_allclose(float(res.inertia), want, rtol=1e-5)
    np.testing.assert_allclose(
        float(trimmed_inertia(x, res.centers, res.labels, t)), want,
        rtol=1e-5)
    assert float(res.inertia) < objective64(pts, res.labels.numpy(),
                                            res.centers.numpy())


@pytest.mark.parametrize("name", ["mean", "trimmed_mean", "median"])
def test_restarts_are_scored_by_the_trimmed_objective(name):
    """restarts=r keeps the run of lowest objective (trimmed where the
    aggregator has a breakdown point), the caller's generator first."""
    pts, _ = attacked_blobs(6, [40, 25, 60, 35], 6, frac=0.15)
    x = torch.from_numpy(pts)
    agg = None if name == "mean" else tmake(name, beta=0.2)
    best = device_kmeans(make_generator(11, CPU), x, 4, restarts=4,
                         aggregator=agg)
    gen = make_generator(11, CPU)
    runs = [device_kmeans(gen if i == 0 else _restart_generator(gen, i), x,
                          4, aggregator=agg) for i in range(4)]
    objs = [float(r.inertia) for r in runs]
    assert float(best.inertia) == min(objs)
    assert best.restart_spread == pytest.approx(max(objs) - min(objs))
    t = int(min(getattr(agg, "breakdown", 0.0), 0.45) * len(pts))
    for r in runs:
        np.testing.assert_allclose(
            float(r.inertia),
            objective64(pts, r.labels.numpy(), r.centers.numpy(), t),
            rtol=1e-5)


def test_family_reports_the_effective_restarts():
    pts, truth = make_blobs(8, [30, 30, 30], 6, sep=25.0, noise=0.25)
    x = torch.from_numpy(pts)
    algo = get_algorithm("kmeans-device")
    for opts, want in (({"init": "spectral", "restarts": 4}, 1),
                       ({"init": "spectral", "restarts": 4, "batch_m": 20}, 4),
                       ({"init": "spectral", "restarts": 4, "batch_m": 90}, 1),
                       ({"init": "kmeans++", "restarts": 3}, 3),
                       ({"init": "random", "restarts": 2,
                         "aggregator": "median"}, 2)):
        res = algo.device_call(make_generator(0, CPU), x, k=3, **opts)
        meta = meta_to_host(res.meta)
        assert meta["restarts"] == want, opts
        assert cluster_agreement(res.labels.numpy(), truth) == 1.0, opts


def test_row_replay_refuses_draws_that_do_not_fit():
    pts, _ = make_blobs(9, [10, 10], 3)
    x = torch.from_numpy(pts)
    for draws, match in (([np.arange(5)], r"not \(6,\)"),
                         ([np.arange(15, 21)], "rows of 20"),
                         ([np.arange(6)], "only 1 given")):
        with pytest.raises(ValueError, match=match):
            device_kmeans(make_generator(0, CPU), x, 2, init="warm",
                          init_centers=x[:2], batch_m=6, iters=2,
                          sampler=rows_from_numpy(*draws))
