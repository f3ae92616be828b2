"""The port's host clustering families against the JAX reference, on the
CPU: spectral seeding, the host Lloyd loop, gradient clustering, the
admissibility margins and the registry's request mapping.

Both packages get the same numpy points.  The reference's random draws
(the ``random`` init's rows, the kmeans++ seeds) are carried across
(``interop.rows_from_numpy``, explicit start centers).  Seed rows,
labels and iteration counts must be equal; centers agree within rtol
1e-5 and atol 1e-5 * max|x|; the margins (float64 on both sides) within
rtol 1e-9.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.clustering import admissible as jadm
from repro.core.clustering import api as japi
from repro.core.clustering.gradient import gradient_clustering as jgrad
from repro.core.clustering.kmeans import kmeans as jkmeans
from repro.core.clustering.kmeans import kmeans_plus_plus_init as jkmeanspp
from repro.core.clustering.kmeans import spectral_init as jspectral
from repro.core.sketch import sketch_tree as jsketch_tree
from repro_torch import runtime
from repro_torch.core.clustering import admissible as tadm
from repro_torch.core.clustering import api as tapi
from repro_torch.core.clustering.gradient import gradient_steps
from repro_torch.core.clustering.kmeans import kmeans, spectral_init
from repro_torch.core.sketch import make_generator
from repro_torch.interop import rows_from_numpy

from conftest import same_partition
from test_torch_engine import make_blobs


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One host thread: the tensors here are small, and parallel test
    workers must not oversubscribe the CPU."""
    with runtime.pinned_threads(1):
        yield


CPU = "cpu"


def ridge_sketches(c, k=8, d=16, s=64, seed=0):
    """Sketched ridge-like client models around k staggered optima, the
    way simulate plants them (cluster j's coordinates of magnitude in
    [j + 1, j + 2], random signs), through the reference's JL sketch."""
    rng = np.random.default_rng(seed)
    optima = (rng.choice([-1.0, 1.0], size=(k, d))
              * (np.arange(1, k + 1)[:, None] + rng.uniform(size=(k, d))))
    truth = np.arange(c) % k
    thetas = (optima[truth] + 0.15 * rng.normal(size=(c, d))).astype(
        np.float32)
    sk = jax.vmap(lambda t: jsketch_tree(jax.random.PRNGKey(seed),
                                         {"theta": t}, s))(jnp.asarray(thetas))
    return np.array(sk), truth


def row_index(points, seeds):
    return [int(np.flatnonzero((points == r).all(1))[0]) for r in seeds]


SPECTRAL_CASES = [("blobs", 0, [60, 50, 70, 40], 8),
                  ("blobs", 1, [30, 90, 45], 16),
                  ("blobs", 2, [9, 9, 9, 9, 9], 4),
                  ("sketches", 3, 1024, 8),
                  ("sketches", 4, 4096, 8)]


def spectral_points(kind, seed, sizes, d):
    if kind == "blobs":
        pts, truth = make_blobs(seed, sizes, d)
        return pts, truth, len(sizes)
    pts, truth = ridge_sketches(sizes, k=d, seed=seed)
    return pts, truth, d


@pytest.mark.parametrize("kind,seed,sizes,d", SPECTRAL_CASES)
def test_spectral_seed_rows_equal_reference(kind, seed, sizes, d):
    pts, _, k = spectral_points(kind, seed, sizes, d)
    want = np.asarray(jspectral(jnp.asarray(pts), k))
    got = spectral_init(torch.from_numpy(pts), k).numpy()
    assert row_index(pts, got) == row_index(pts, want)


@pytest.mark.parametrize("kind,seed,sizes,d", SPECTRAL_CASES)
def test_host_kmeans_spectral_matches_reference(kind, seed, sizes, d):
    pts, truth, k = spectral_points(kind, seed, sizes, d)
    want = jkmeans(jax.random.PRNGKey(seed), jnp.asarray(pts), k, iters=50,
                   init="spectral")
    got = kmeans(make_generator(seed, CPU), torch.from_numpy(pts), k,
                 iters=50, init="spectral")
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert got.n_iter == int(want.n_iter)
    scale = float(np.abs(pts).max())
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(want.centers),
                               rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(float(got.inertia), float(want.inertia),
                               rtol=1e-4)
    if kind == "sketches":
        assert same_partition(got.labels.numpy(), truth)


@pytest.mark.parametrize("seed,sizes,d,iters", [
    (5, [60, 50, 70, 40], 8, 50), (6, [30, 90, 45], 16, 50),
    (7, [100, 100, 100, 100, 100], 4, 3), (8, [7, 5], 2, 50)])
def test_host_kmeans_random_init_with_carried_rows(seed, sizes, d, iters):
    pts, _ = make_blobs(seed, sizes, d)
    k, m = len(sizes), len(pts)
    key = jax.random.PRNGKey(seed)
    rows = np.asarray(jax.random.choice(key, m, (k,), replace=False))
    want = jkmeans(key, jnp.asarray(pts), k, iters=iters, init="random")
    sampler = rows_from_numpy(rows)
    got = kmeans(make_generator(seed, CPU), torch.from_numpy(pts), k,
                 iters=iters, init="random", sampler=sampler)
    assert sampler.calls == 1
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert got.n_iter == int(want.n_iter)
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(want.centers),
                               rtol=1e-5, atol=1e-5 * float(np.abs(pts).max()))


@pytest.mark.parametrize("seed,sizes,d,alpha,iters", [
    (0, [60, 50, 70, 40], 8, 0.5, 100), (1, [30, 90, 45], 16, 0.25, 60),
    (2, [9, 9, 9, 9, 9], 4, 1.0, 20), (3, [7, 5], 2, 0.5, 5)])
def test_gradient_clustering_from_reference_seeds(seed, sizes, d, alpha,
                                                  iters):
    pts, _ = make_blobs(seed, sizes, d)
    k = len(sizes)
    key = jax.random.PRNGKey(seed)
    c0 = np.array(jkmeanspp(key, jnp.asarray(pts), k))
    want = jgrad(key, jnp.asarray(pts), k, alpha=alpha, iters=iters)
    got = gradient_steps(torch.from_numpy(pts), torch.from_numpy(c0),
                         alpha=alpha, iters=iters)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert got.n_iter == int(want.n_iter) == iters
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(want.centers),
                               rtol=1e-5, atol=1e-5 * float(np.abs(pts).max()))
    np.testing.assert_allclose(float(got.inertia), float(want.inertia),
                               rtol=1e-4)


@pytest.mark.parametrize("seed,sizes,d", [(0, [60, 50, 70, 40], 8),
                                          (1, [30, 90, 45], 16),
                                          (2, [1, 9, 4], 3),
                                          (3, [20], 5)])
def test_admissibility_margins_match_reference(seed, sizes, d):
    pts, truth = make_blobs(seed, sizes, d)
    want = jadm.separability_alpha(pts, truth)
    for points in (pts, torch.from_numpy(pts)):
        got = tadm.separability_alpha(points, truth)
        assert got == pytest.approx(want, rel=1e-9)
        assert tadm.is_separable(points, truth, 1.0) == jadm.is_separable(
            pts, truth, 1.0)
    m, c_min = len(pts), min(sizes)
    assert tadm.alpha_kmeans(m, c_min) == jadm.alpha_kmeans(m, c_min)
    assert tadm.alpha_convex_clustering(m, c_min) == \
        jadm.alpha_convex_clustering(m, c_min)
    for name in tapi.list_algorithms():
        assert tapi.get_algorithm(name).admissibility_alpha(m, c_min) == \
            japi.get_algorithm(name).admissibility_alpha(m, c_min)
    one = np.zeros(len(pts), np.int32)
    assert tadm.separability_alpha(pts, one) == pytest.approx(
        jadm.separability_alpha(pts, one))


def test_list_algorithms_equals_reference():
    assert tapi.list_algorithms() == japi.list_algorithms()
    assert tapi.LLOYD_DEVICE_INIT == japi.LLOYD_DEVICE_INIT
    for name in tapi.list_algorithms():
        t, j = tapi.get_algorithm(name), japi.get_algorithm(name)
        assert t.requires_k == j.requires_k
        assert tapi.is_device_algorithm(t) == japi.is_device_algorithm(j)
        twin_t, twin_j = tapi.device_twin(t), japi.device_twin(j)
        assert getattr(twin_t, "name", None) == getattr(twin_j, "name", None)


@dataclasses.dataclass(frozen=True)
class _HostOnly:
    name: str = "host-only"
    requires_k: bool = True

    def __call__(self, key, points, *, k=None, **_):
        raise AssertionError("not called")


@dataclasses.dataclass(frozen=True)
class _DeviceOnly(_HostOnly):
    name: str = "twinless-device"

    def device_call(self, key, points, *, k=None, **_):
        raise AssertionError("not called")


@pytest.fixture
def plugins():
    for api in (tapi, japi):
        api.register_algorithm(_HostOnly())
        api.register_algorithm(_DeviceOnly())
    yield
    for api in (tapi, japi):
        api.unregister_algorithm("host-only")
        api.unregister_algorithm("twinless-device")


REQUESTS = [("kmeans", None), ("kmeans++", {"iters": 3}),
            ("spectral", {"restarts": 2}), ("kmeans-device", None),
            ("kmeans-device", {"init": "random", "iters": 4}),
            ("kmeans-device", {"init": "spectral"}), ("gradient", None),
            ("gradient-device", {"alpha": 0.3}), ("convex", {"lam": 1.0}),
            ("convex-device", None), ("clusterpath-device", {"iters": 9}),
            ("clusterpath", None), ("host-only", {"iters": 2}),
            ("twinless-device", None)]


@pytest.mark.parametrize("name,options", REQUESTS)
def test_request_mapping_matches_reference(plugins, name, options):
    calls = [("host", lambda api: api.resolve_host_request(name, options)),
             ("device", lambda api: api.resolve_device_request(name, options)),
             ("auto", lambda api: api.resolve_device_request(
                 name, options, strict=False))]
    for label, call in calls:
        try:
            want = call(japi)
        except ValueError as err:
            with pytest.raises(ValueError) as got:
                call(tapi)
            assert str(got.value) == str(err), label
            continue
        assert call(tapi) == want, label


def test_request_mapping_errors(plugins):
    with pytest.raises(ValueError, match="init='warm'"):
        tapi.resolve_host_request("kmeans-device", {"init": "warm"})
    with pytest.raises(ValueError, match="no registered host base"):
        tapi.resolve_host_request("twinless-device")
    with pytest.raises(ValueError, match="'-device' twin"):
        tapi.resolve_device_request("host-only")
    assert tapi.resolve_device_request("host-only", {"a": 1},
                                       strict=False) == ("host-only",
                                                         {"a": 1})
    assert tapi.resolve_host_request("kmeans-device", {"init": "spectral",
                                                       "iters": 3}) == \
        ("spectral", {"iters": 3})


def test_host_families_run_on_the_points_device():
    pts, truth = make_blobs(9, [30, 30, 30], 6, sep=25.0, noise=0.25)
    x = torch.from_numpy(pts)
    for name, opts in (("kmeans", {}), ("kmeans++", {}), ("spectral", {}),
                       ("gradient", {"iters": 20}),
                       ("kmeans-device", {"batch_m": 40}),
                       ("gradient-device", {"iters": 20})):
        res = tapi.get_algorithm(name)(make_generator(0, CPU), x, k=3, **opts)
        assert res.labels.shape == truth.shape, name
        assert res.centers.shape == (res.n_clusters, 6)
        if name != "kmeans":
            # one random init may seed two centers in one blob
            assert same_partition(res.labels, truth), name
        assert tapi.separability_of(pts, res) == pytest.approx(
            japi.separability_of(pts, japi.ClusteringResult(
                labels=res.labels, centers=res.centers,
                n_clusters=res.n_clusters,
                meta={})), rel=1e-9)
    with pytest.raises(ValueError, match="requires k"):
        tapi.get_algorithm("spectral")(make_generator(0, CPU), x)
    dev = tapi.get_algorithm("gradient-device").device_call(
        make_generator(0, CPU), x, k=3, iters=10)
    meta = tapi.meta_to_host(dev.meta)
    assert tuple(meta) == tapi.DEVICE_META_KEYS and meta["n_iter"] == 10
    assert meta["n_clusters"] == 3 and meta["lam"] is None
