"""The port's paper-scale method API against the reference's, on the CPU:
``core/methods.py``, ``core/ifca.py``, ``core/oracles.py`` and
``core/theory.py`` (the counterparts of ``tests/test_registry_and_methods.py``
and ``tests/test_theory_*.py``).

* ``ODCL.fit`` equals the port's ``odcl()`` bit for bit, and the
  reference's partition of the Section 5 federation (models within rtol
  1e-5).  At the paper's n = 100 the reference's kmeans++ seed rows are
  carried across, and one seeding recovers the partition for the same
  share of keys in both packages.
* The baselines equal the oracle functions, and the reference's numbers
  (float32 within rtol 1e-6).
* IFCA in both modes, from the reference's own initial models
  (``interop.centers_from_numpy``): the same labels every round's end and
  models within rtol 1e-5 / atol 1e-5.
* Theory values equal the reference's within rtol 1e-12.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import methods as jmethods
from repro.core import oracles as joracles
from repro.core import theory as jtheory
from repro.core.clustering.kmeans import kmeans_plus_plus_init as jkmeanspp
from repro.core.erm import batched_ridge_erm as jridge
from repro.core.ifca import IFCAConfig as JIFCAConfig
from repro.core.ifca import ifca as jifca
from repro.core.ifca import ifca_init_annulus as jannulus
from repro.core.ifca import per_user_model_losses as jlosses
from repro.data import make_linear_regression_federation
from repro_torch import runtime
from repro_torch.core import oracles, theory
from repro_torch.core.clustering.api import (
    ClusteringResult,
    register_algorithm,
    unregister_algorithm,
)
from repro_torch.core.erm import batched_ridge_erm
from repro_torch.core.ifca import (
    IFCAConfig,
    ifca,
    ifca_init_annulus,
    ifca_init_near_optima,
    per_user_model_losses,
)
from repro_torch.core.methods import (
    IFCA,
    ODCL,
    ClusterOracle,
    GlobalERM,
    LocalOnly,
    Method,
    MethodResult,
    OracleAveraging,
    get_method,
    list_methods,
    register_method,
)
from repro_torch.core.odcl import odcl
from repro_torch.core.sketch import make_generator
from repro_torch.interop import centers_from_numpy

from conftest import same_partition


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One host thread: the tensors here are small, and parallel test
    workers must not oversubscribe the CPU."""
    with runtime.pinned_threads(1):
        yield


CPU = "cpu"


@pytest.fixture(scope="module")
def fed():
    return make_linear_regression_federation(seed=0, n=200)


@pytest.fixture(scope="module")
def paper_fed():
    """The Section 5 federation at the paper's own n = 100."""
    return make_linear_regression_federation(seed=0)


def ridge(xs, ys):
    return batched_ridge_erm(torch.as_tensor(xs), torch.as_tensor(ys), 1e-8)


def jridge_solver(xs, ys):
    return jridge(jnp.asarray(xs), jnp.asarray(ys), 1e-8)


def sq_loss(t, x, y):
    r = x @ t - y
    return torch.mean(r * r)


def jsq_loss(t, x, y):
    r = x @ t - y
    return jnp.mean(r * r)


# ------------------------------------------------------------- registry

def test_method_registry_lists_the_reference_methods():
    assert list_methods() == jmethods.list_methods()
    assert get_method("odcl") is ODCL and get_method("ifca") is IFCA
    with pytest.raises(KeyError, match="unknown federated method"):
        get_method("nope")

    @dataclasses.dataclass
    class Probe:
        name: str = "probe-method"

    try:
        register_method(Probe)
        assert get_method("probe-method") is Probe
        with pytest.raises(ValueError, match="already registered"):
            register_method(Probe)
    finally:
        from repro_torch.core import methods
        methods._METHODS.pop("probe-method", None)
    for cls in (ODCL(), GlobalERM(), LocalOnly(), OracleAveraging()):
        assert isinstance(cls, Method)


# ------------------------------------------------------------- ODCL

def test_odcl_method_matches_function_api_bit_for_bit(fed):
    local = ridge(fed.xs, fed.ys)
    legacy = odcl(local, algorithm="kmeans++", k=10, seed=0)
    res = ODCL(algorithm="kmeans++", k=10).fit(
        make_generator(0, CPU), fed.xs, fed.ys, ridge)
    np.testing.assert_array_equal(res.labels, legacy.labels)
    np.testing.assert_array_equal(res.user_models, legacy.user_models)
    np.testing.assert_array_equal(res.cluster_models, legacy.cluster_models)
    assert res.n_clusters == legacy.n_clusters == 10
    assert res.comm_rounds == 1 and res.meta == legacy.meta
    # an int key seeds the same generator
    again = ODCL(algorithm="kmeans++", k=10, device=CPU).fit(
        0, fed.xs, fed.ys, lambda xs, ys: ridge(xs, ys).numpy())
    np.testing.assert_array_equal(again.labels, res.labels)


@pytest.mark.parametrize("method,options", [
    (("kmeans++", 10), {}),
    (("clusterpath", None), {"n_lambdas": 8, "iters": 200})])
def test_odcl_partition_matches_reference(fed, method, options):
    algorithm, k = method
    jmethod = jmethods.ODCL(algorithm=algorithm, k=k, options=options)
    tmethod = ODCL(algorithm=algorithm, k=k, options=options, device=CPU)
    want = jmethod.fit(jax.random.PRNGKey(0), fed.xs, fed.ys, jridge_solver)
    got = tmethod.fit(0, fed.xs, fed.ys, ridge)
    assert same_partition(got.labels, want.labels)
    assert same_partition(got.labels, fed.true_labels)
    assert tmethod.name == jmethod.name
    np.testing.assert_allclose(got.user_models, want.user_models,
                               rtol=1e-5, atol=1e-5)
    assert got.mse(fed.optima, fed.true_labels) == pytest.approx(
        want.mse(fed.optima, fed.true_labels), rel=1e-4)


def test_odcl_kmeanspp_at_paper_size_from_reference_seeds(paper_fed):
    """At n = 100 one kmeans++ seeding lands in a local optimum for about
    one key in six, in either package, and the port's own draw for key 0
    is one of those (so the n = 200 case above stands for the paper's
    partition).  With the reference's seed rows for key 0 carried across
    (the device Lloyd from ``init_centers``), the port finds the
    reference's partition, which is the true one."""
    fed = paper_fed
    jlocal = jridge_solver(fed.xs, fed.ys)
    want = jmethods.ODCL(algorithm="kmeans++", k=10).fit(
        jax.random.PRNGKey(0), fed.xs, fed.ys, jridge_solver)
    seeds = np.asarray(jkmeanspp(jax.random.PRNGKey(0), jlocal, 10))
    got = ODCL(algorithm="kmeans-device", k=10, device=CPU, options={
        "init": "warm", "init_centers": centers_from_numpy(seeds, CPU)}).fit(
        0, fed.xs, fed.ys, ridge)
    assert same_partition(want.labels, fed.true_labels)
    assert same_partition(got.labels, want.labels)
    np.testing.assert_allclose(got.user_models, want.user_models,
                               rtol=1e-5, atol=1e-5)
    assert got.mse(fed.optima, fed.true_labels) == pytest.approx(
        want.mse(fed.optima, fed.true_labels), rel=1e-4)


def test_kmeanspp_recovery_rate_matches_reference(paper_fed):
    """Over keys 0..499 at n = 100, one kmeans++ seeding recovers the true
    partition for the same share of keys in both packages: the counts
    differ by at most 4 binomial sigma of a difference of two shares
    (printed with ``-s``)."""
    fed, keys = paper_fed, 500
    jlocal = jridge_solver(fed.xs, fed.ys)
    local = ridge(fed.xs, fed.ys)
    jmethod = jmethods.ODCL(algorithm="kmeans++", k=10)
    tmethod = ODCL(algorithm="kmeans++", k=10, device=CPU)
    ref = sum(same_partition(jmethod.fit(
        jax.random.PRNGKey(key), None, None, lambda xs, ys: jlocal).labels,
        fed.true_labels) for key in range(keys))
    port = sum(same_partition(tmethod.fit(
        key, None, None, lambda xs, ys: local).labels, fed.true_labels)
        for key in range(keys))
    print(f"kmeans++ recovers the Section 5 partition (n = 100) for "
          f"{ref}/{keys} keys (reference) and {port}/{keys} (port)")
    share = (ref + port) / (2 * keys)
    assert 0.5 < share < 1.0
    assert abs(ref - port) / keys <= 4.0 * np.sqrt(
        2.0 * share * (1.0 - share) / keys)


def test_new_algorithm_usable_via_method_and_function_api():
    rng = np.random.default_rng(1)
    pts = np.concatenate([rng.normal(size=(10, 4)) + 30.0,
                          rng.normal(size=(10, 4)) - 30.0]).astype(np.float32)

    @dataclasses.dataclass(frozen=True)
    class FirstCoordSign:
        name: str = "first-coord-sign"
        requires_k: bool = False

        def __call__(self, generator, points, *, k=None, **options):
            labels = (np.asarray(points)[:, 0] > 0).astype(np.int32)
            centers = np.stack([np.asarray(points)[labels == c].mean(0)
                                for c in range(2)])
            return ClusteringResult(labels=labels, centers=centers,
                                    n_clusters=2, meta={})

        def admissibility_alpha(self, m, c_min):
            return 1.0

    try:
        register_algorithm(FirstCoordSign())
        via_method = ODCL(algorithm="first-coord-sign", device=CPU).fit(
            0, None, None, erm=lambda xs, ys: pts)
        via_fn = odcl(pts, algorithm="first-coord-sign", device=CPU)
        assert via_method.n_clusters == via_fn.n_clusters == 2
        np.testing.assert_array_equal(via_method.labels, via_fn.labels)
        np.testing.assert_array_equal(via_method.user_models,
                                      via_fn.user_models)
        assert "separability_alpha" in via_method.meta
    finally:
        unregister_algorithm("first-coord-sign")


def test_assert_separable_flags_bad_clustering():
    pts = np.random.default_rng(0).normal(size=(20, 4)).astype(np.float32)
    with pytest.raises(ValueError, match="not separable"):
        ODCL(algorithm="kmeans++", k=4, assert_separable=True,
             device=CPU).fit(0, None, None, erm=lambda xs, ys: pts)
    with pytest.raises(ValueError, match="local ERM"):
        ODCL(device=CPU).fit(0, None, None)


# ----------------------------------------------------------- baselines

def test_baseline_methods_match_oracle_functions_and_reference(fed):
    local = ridge(fed.xs, fed.ys).numpy()
    jlocal = np.asarray(jridge_solver(fed.xs, fed.ys))
    np.testing.assert_allclose(local, jlocal, rtol=1e-5, atol=1e-5)
    key = jax.random.PRNGKey(0)
    cases = [
        (OracleAveraging(true_labels=fed.true_labels),
         jmethods.OracleAveraging(true_labels=fed.true_labels),
         oracles.oracle_averaging(local, fed.true_labels)),
        (LocalOnly(), jmethods.LocalOnly(), local),
        (GlobalERM(), jmethods.GlobalERM(), oracles.naive_averaging(local)),
    ]
    for port, ref, want in cases:
        got = port.fit(None, fed.xs, fed.ys, ridge)
        np.testing.assert_array_equal(got.user_models, want)
        # the reference's method on the port's local models: bit for bit
        theirs = ref.fit(key, fed.xs, fed.ys, lambda xs, ys: local)
        np.testing.assert_array_equal(got.user_models, theirs.user_models)
        np.testing.assert_array_equal(got.labels, theirs.labels)
        assert (got.n_clusters, got.comm_rounds, port.name) == (
            theirs.n_clusters, theirs.comm_rounds, ref.name)
        if theirs.cluster_models is None:
            assert got.cluster_models is None
        else:
            np.testing.assert_array_equal(got.cluster_models,
                                          theirs.cluster_models)
    oa, ge = cases[0][0].fit(None, fed.xs, fed.ys, ridge), cases[2][0].fit(
        None, fed.xs, fed.ys, ridge)
    assert oa.nmse(fed.optima, fed.true_labels) < ge.nmse(fed.optima,
                                                          fed.true_labels)


def test_cluster_oracle_matches_reference(fed):
    def solve(x, y):
        return ridge(x[None], y[None])[0]

    def jsolve(x, y):
        return jridge_solver(x[None], y[None])[0]

    got = ClusterOracle(solve_fn=solve, true_labels=fed.true_labels).fit(
        None, fed.xs, fed.ys)
    want = jmethods.ClusterOracle(solve_fn=jsolve,
                                  true_labels=fed.true_labels).fit(
        None, fed.xs, fed.ys)
    np.testing.assert_allclose(got.user_models, want.user_models,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.n_clusters == want.n_clusters == 10


def test_method_result_metrics_equal_reference():
    rng = np.random.default_rng(2)
    models = rng.normal(size=(12, 3)).astype(np.float32)
    optima, labels = rng.normal(size=(4, 3)), np.arange(12) % 4
    args = dict(user_models=models, labels=labels, cluster_models=None,
                n_clusters=4, comm_rounds=1, meta={})
    got, want = MethodResult(**args), jmethods.MethodResult(**args)
    assert got.mse(optima, labels) == want.mse(optima, labels)
    assert got.nmse(optima, labels) == want.nmse(optima, labels)
    assert got.nmse(optima, labels, eps=5.0) == want.nmse(optima, labels,
                                                          eps=5.0)


# ---------------------------------------------------------------- IFCA

@pytest.fixture(scope="module")
def small_fed():
    return make_linear_regression_federation(seed=3, m=40, K=4, n=100)


def test_per_user_losses_equal_reference(small_fed):
    theta = np.random.default_rng(0).normal(size=(4, 20)).astype(np.float32)
    want = np.asarray(jlosses(jnp.asarray(theta), jnp.asarray(small_fed.xs),
                              jnp.asarray(small_fed.ys), jsq_loss))
    got = per_user_model_losses(torch.from_numpy(theta),
                                torch.from_numpy(small_fed.xs),
                                torch.from_numpy(small_fed.ys), sq_loss)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("mode,rounds,local_steps", [
    ("gradient", 60, 5), ("model", 15, 3)])
def test_ifca_matches_reference_from_its_theta0(small_fed, mode, rounds,
                                                local_steps):
    theta0 = np.asarray(jannulus(jax.random.PRNGKey(0),
                                 jnp.asarray(small_fed.optima), small_fed.D))
    jcfg = JIFCAConfig(k=4, rounds=rounds, step_size=0.1, mode=mode,
                       local_steps=local_steps)
    jtheta, jlabels, jhist = jifca(jnp.asarray(theta0),
                                   jnp.asarray(small_fed.xs),
                                   jnp.asarray(small_fed.ys), jsq_loss,
                                   jax.grad(jsq_loss), jcfg)
    cfg = IFCAConfig(k=4, rounds=rounds, step_size=0.1, mode=mode,
                     local_steps=local_steps)
    theta, labels, hist = ifca(centers_from_numpy(theta0, CPU),
                               torch.from_numpy(small_fed.xs),
                               torch.from_numpy(small_fed.ys), sq_loss,
                               torch.func.grad(sq_loss), cfg)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
    assert hist.shape == jhist.shape == (rounds, 4, 20)
    np.testing.assert_allclose(hist.numpy(), np.asarray(jhist), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(theta.numpy(), np.asarray(jtheta), rtol=1e-5,
                               atol=1e-5)
    # the method wrapper, from the same initial models
    want = jmethods.IFCA(k=4, loss_fn=jsq_loss, grad_fn=jax.grad(jsq_loss),
                         init=theta0, rounds=rounds, mode=mode,
                         local_steps=local_steps).fit(
        jax.random.PRNGKey(0), small_fed.xs, small_fed.ys)
    got = IFCA(k=4, loss_fn=sq_loss, grad_fn=torch.func.grad(sq_loss),
               init=theta0, rounds=rounds, mode=mode,
               local_steps=local_steps, device=CPU).fit(
        0, small_fed.xs, small_fed.ys)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_allclose(got.user_models, want.user_models,
                               rtol=1e-5, atol=1e-5)
    assert got.comm_rounds == want.comm_rounds == float(rounds)
    assert got.meta["history"].shape == (rounds, 4, 20)


def test_ifca_argmin_ties_go_to_the_lowest_index():
    xs = torch.zeros((3, 4, 2))
    ys = torch.zeros((3, 4))
    theta = torch.zeros((3, 2))            # every model has the same loss
    _, labels, _ = ifca(theta, xs, ys, sq_loss, torch.func.grad(sq_loss),
                        IFCAConfig(k=3, rounds=1))
    assert labels.tolist() == [0, 0, 0]


def test_ifca_inits_and_convergence(small_fed):
    gen = make_generator(0, CPU)
    optima = torch.from_numpy(small_fed.optima)
    ann = ifca_init_annulus(gen, small_fed.optima, small_fed.D)
    dist = torch.linalg.vector_norm(ann - optima, dim=1)
    assert bool((dist >= 0.2 * small_fed.D - 1e-4).all())
    assert bool((dist <= small_fed.D / 3 + 1e-4).all())
    near = ifca_init_near_optima(gen, small_fed.optima, 0.1)
    assert near.shape == (4, 20) and float((near - optima).abs().max()) < 1.0
    thetaT, labels, _ = ifca(ann, small_fed.xs, small_fed.ys, sq_loss,
                             torch.func.grad(sq_loss),
                             IFCAConfig(k=4, rounds=120))
    err = float(torch.mean(torch.sum((thetaT - optima) ** 2, -1)))
    err0 = float(torch.mean(torch.sum((ann - optima) ** 2, -1)))
    assert err < 0.1 * err0
    assert same_partition(labels.numpy(), small_fed.true_labels)


# -------------------------------------------------------------- theory

C0 = theory.ProblemConstants(L=1.0, mu_F=0.5, R=2.0, d=20, G_F=3.0, N=1.5,
                             F_star=0.2, beta=2.0)
J0 = jtheory.ProblemConstants(**dataclasses.asdict(C0))


@pytest.mark.parametrize("name,args", [
    ("constant_M", (C0,)),
    ("sample_threshold", (100.0, 3.0, 5.0, 0.5)),
    ("threshold_odcl_cc", (100.0, 100, 10, 5.0, 0.5)),
    ("threshold_odcl_km", (100.0, 100, 10, 5.0, 0.5)),
    ("threshold_odcl_km", (100.0, 100, 10, 5.0, 0.5, 2.0)),
    ("ifca_comm_rounds", (4.0, 0.5, 10.0, 1e-3)),
    ("all_for_all_comm_rounds", (100, 100, 10)),
    ("communication_saving", (4.0, 0.5, 10.0, 1e-3)),
    ("mse_bound_theorem1", (C0, 200, 10, 10, 8, 1.0, 2.0, 0.5, 100)),
    ("merge_condition", (50, 200)),
])
def test_theory_values_equal_reference(name, args):
    jargs = tuple(J0 if a is C0 else a for a in args)
    got = getattr(theory, name)(*args)
    want = getattr(jtheory, name)(*jargs)
    assert got == pytest.approx(want, rel=1e-12)


def test_oracle_functions_equal_reference():
    rng = np.random.default_rng(5)
    local = rng.normal(size=(30, 4))
    labels = rng.integers(0, 3, size=30)
    np.testing.assert_array_equal(oracles.oracle_averaging(local, labels),
                                  joracles.oracle_averaging(local, labels))
    np.testing.assert_array_equal(oracles.naive_averaging(local),
                                  joracles.naive_averaging(local))
    np.testing.assert_array_equal(oracles.local_erm(local),
                                  joracles.local_erm(local))
