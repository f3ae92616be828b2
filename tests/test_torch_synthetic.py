"""The port's synthetic federations against the reference's (numpy, both).

Without a scenario every federation is the reference's bit for bit: the
same ``np.random.default_rng`` calls in the same order.  With a scenario
the hooks draw from the port's keys; with the reference's Byzantine mask
carried across (``interop.draws_from_numpy``) the attacked federation is
again the reference's bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.data import synthetic as jsyn
from repro.scenarios import library as jlib
from repro_torch import runtime
from repro_torch.data import synthetic as tsyn
from repro_torch.data import (
    make_linear_regression_federation,
    make_logistic_federation,
    make_mnist_like_federation,
)
from repro_torch.interop import draws_from_numpy
from repro_torch.scenarios import ByzantineScenario, DriftScenario, library


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One host thread: the tensors here are small, and parallel test
    workers must not oversubscribe the CPU."""
    with runtime.pinned_threads(1):
        yield


def assert_same_federation(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if b is None:
            assert a is None, f.name
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert (got.m, got.n, got.K) == (want.m, want.n, want.K)


@pytest.mark.parametrize("seed,kw", [
    (0, {}), (3, {"m": 40, "K": 4, "n": 100}), (1, {"n": 50, "d": 8}),
    (7, {"m": 12, "K": 3, "n": 5, "d": 6, "noise_std": 0.5})])
def test_linear_regression_federation_bit_exact(seed, kw):
    assert_same_federation(make_linear_regression_federation(seed, **kw),
                           jsyn.make_linear_regression_federation(seed, **kw))


def test_explicit_optima_and_helpers_bit_exact():
    optima = np.arange(18, dtype=np.float64).reshape(3, 6)
    assert_same_federation(
        make_linear_regression_federation(2, m=9, K=3, n=6, d=6,
                                          optima=optima),
        jsyn.make_linear_regression_federation(2, m=9, K=3, n=6, d=6,
                                               optima=optima))
    for d in (5, 20):
        np.testing.assert_array_equal(
            tsyn.paper_synthetic_optima(np.random.default_rng(d), d),
            jsyn.paper_synthetic_optima(np.random.default_rng(d), d))
    assert tsyn.min_separation(optima) == jsyn.min_separation(optima)


@pytest.mark.parametrize("seed,kw", [(0, {}), (4, {"m": 20, "K": 2,
                                                   "n": 30})])
def test_logistic_federation_bit_exact(seed, kw):
    assert_same_federation(make_logistic_federation(seed, **kw),
                           jsyn.make_logistic_federation(seed, **kw))


@pytest.mark.parametrize("seed,kw", [(0, {}), (5, {"m": 10, "n": 6,
                                                   "n_test": 20})])
def test_mnist_like_federation_bit_exact(seed, kw):
    assert_same_federation(make_mnist_like_federation(seed, **kw),
                           jsyn.make_mnist_like_federation(seed, **kw))


def test_scenario_federation_with_carried_mask_bit_exact():
    """The reference draws its attackers from PRNGKey(seed); handed the
    same mask, the port's federation is the reference's."""
    m, frac = 40, 0.25
    want = jsyn.make_linear_regression_federation(
        0, m=m, K=4, n=8, d=6, scenario=jlib.ByzantineScenario(frac=frac))
    mask = np.asarray(jlib._mask_by_index(
        jax.random.fold_in(jax.random.PRNGKey(0), jlib._TAG_ROLE),
        jnp.arange(m), frac))
    scen = ByzantineScenario(frac=frac, draws=draws_from_numpy(
        masks={library._TAG_ROLE: mask}))
    got = make_linear_regression_federation(0, m=m, K=4, n=8, d=6,
                                            scenario=scen)
    assert_same_federation(got, want)


def test_synthetic_federation_applies_scenario():
    fed = make_linear_regression_federation(
        seed=0, m=40, K=4, n=8, d=6, scenario=ByzantineScenario(frac=0.25))
    assert fed.honest is not None and fed.honest.shape == (40,)
    assert 0 < (~fed.honest).sum() < 40
    assert make_linear_regression_federation(
        seed=0, m=40, K=4, n=8, d=6).honest is None
    clean = make_linear_regression_federation(seed=0, m=40, K=4, n=8, d=6,
                                              scenario="none")
    assert clean.honest is not None and clean.honest.all()
    np.testing.assert_array_equal(fed.true_labels, clean.true_labels)
    np.testing.assert_array_equal(fed.ys[~fed.honest], -clean.ys[~fed.honest])
    np.testing.assert_array_equal(fed.ys[fed.honest], clean.ys[fed.honest])
    # the identity scenario draws nothing: the reference's federation
    # under it (round-robin occupancy, everyone honest) bit for bit
    assert_same_federation(clean, jsyn.make_linear_regression_federation(
        0, m=40, K=4, n=8, d=6, scenario="none"))


def test_drift_and_longtail_reshape_the_truth():
    drift = make_linear_regression_federation(
        1, m=60, K=4, n=5, d=6,
        scenario=DriftScenario(drift_frac=1.0, drift_at=0.5))
    base = np.arange(60) % 4                    # a scenario's round robin
    np.testing.assert_array_equal(drift.true_labels[:30], base[:30])
    np.testing.assert_array_equal(drift.true_labels[30:], (base[30:] + 1) % 4)
    lt = make_linear_regression_federation(1, m=60, K=4, n=5, d=6,
                                           scenario="longtail")
    want = np.asarray(jlib.LongtailScenario().population(
        jax.random.PRNGKey(1), 60, 4))
    np.testing.assert_array_equal(lt.true_labels, want)
