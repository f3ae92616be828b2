"""The port's per-cluster aggregators against the JAX reference, on the CPU.

Both packages get the same numpy inputs, built from a seed: a (C, n)
stack with an empty cluster, clusters of one and two rows, and tied
values inside clusters.  Tolerance: rtol 1e-5 and atol 1e-5 * max|x|;
the reference itself moves by up to 2.07e-7 relative between eager and
jit (ROADMAP queue C).  The segment sort's order (ranks, permutation) is
integers and must be equal.  ``trimmed_mean`` at a budget of t = 0 must
equal ``mean`` bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import aggregators as jagg
from repro_torch import runtime
from repro_torch.core.engine import aggregators as tagg


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One host thread: the tensors here are small, and parallel test
    workers must not oversubscribe the CPU."""
    with runtime.pinned_threads(1):
        yield


def cluster_stack(seed, sizes, n=6, ties=True):
    """Rows of clusters of the given sizes (0 = an empty cluster), rows
    shuffled; with ``ties`` the values are rounded to quarters, so most
    clusters hold equal values in a column."""
    rng = np.random.default_rng(seed)
    labels = np.repeat(np.arange(len(sizes)), sizes)
    rng.shuffle(labels)
    flat = rng.normal(size=(len(labels), n)) * 3.0 + labels[:, None]
    if ties:
        flat = np.round(flat * 4.0) / 4.0
    return flat.astype(np.float32), labels.astype(np.int32), len(sizes)


def both(flat, labels, k):
    onehot = np.eye(k, dtype=np.float32)[labels]
    counts = onehot.sum(0)
    j = (jnp.asarray(flat), jnp.asarray(labels), jnp.asarray(onehot),
         jnp.asarray(counts))
    t = (torch.from_numpy(flat), torch.from_numpy(labels),
         torch.from_numpy(onehot), torch.from_numpy(counts))
    return j, t


def close(got, want, scale):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * max(scale, 1.0))


CASES = [
    (0, [5, 0, 1, 2, 9, 3], 6, True),      # empty, size-1 and size-2 clusters
    (1, [40, 17, 1, 0, 0, 8], 4, True),
    (2, [12, 12, 12], 16, False),
    (3, [2, 2, 1], 3, True),
    (4, [200, 3, 57, 0, 11], 32, True),
]


@pytest.mark.parametrize("name", ["mean", "trimmed_mean", "median",
                                  "geometric_median"])
@pytest.mark.parametrize("seed,sizes,n,ties", CASES)
def test_aggregator_matches_reference(name, seed, sizes, n, ties):
    flat, labels, k = cluster_stack(seed, sizes, n, ties)
    j, t = both(flat, labels, k)
    want = jagg.get_aggregator(name)(*j)
    got = tagg.get_aggregator(name)(*t)
    assert got.shape == (k, n) and got.dtype == torch.float32
    close(got.numpy(), want, float(np.abs(flat).max()))
    empty = np.asarray([s == 0 for s in sizes])
    assert (got.numpy()[empty] == 0.0).all()


@pytest.mark.parametrize("beta", [0.05, 0.2, 0.3, 0.45])
@pytest.mark.parametrize("seed,sizes,n,ties", CASES)
def test_trimmed_mean_budgets_match_reference(beta, seed, sizes, n, ties):
    flat, labels, k = cluster_stack(seed, sizes, n, ties)
    j, t = both(flat, labels, k)
    want = jagg.make_aggregator("trimmed_mean", beta=beta)(*j)
    got = tagg.make_aggregator("trimmed_mean", beta=beta)(*t)
    close(got.numpy(), want, float(np.abs(flat).max()))


@pytest.mark.parametrize("seed,sizes,n,ties", CASES)
def test_segment_order_equals_reference(seed, sizes, n, ties):
    """Two stable sorts give lax.sort(num_keys=2)'s order: the same
    values, labels, row permutation and ranks, ties included."""
    flat, labels, _ = cluster_stack(seed, sizes, n, ties)
    jv, jl, jp = jagg._segment_sort(jnp.asarray(flat), jnp.asarray(labels))
    tv, tl, tp = tagg._segment_sort(torch.from_numpy(flat),
                                    torch.from_numpy(labels))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(
        tagg._cluster_ranks(torch.from_numpy(flat),
                            torch.from_numpy(labels)).numpy(),
        np.asarray(jagg._cluster_ranks(jnp.asarray(flat),
                                       jnp.asarray(labels))))


@pytest.mark.parametrize("seed,sizes,n,ties", CASES)
def test_trimmed_mean_with_no_trim_is_the_mean_exactly(seed, sizes, n, ties):
    # beta = 0, and a beta whose floor(beta * cnt) is 0 in every cluster
    flat, labels, k = cluster_stack(seed, sizes, n, ties)
    _, t = both(flat, labels, k)
    mean = tagg.get_aggregator("mean")(*t)
    for beta in (0.0, 0.99 / max(sizes)):
        trimmed = tagg.make_aggregator("trimmed_mean", beta=beta)(*t)
        assert torch.equal(trimmed, mean)


@pytest.mark.parametrize("name", ["median", "trimmed_mean",
                                  "geometric_median"])
def test_tied_values_do_not_change_the_aggregate(name):
    """Rows with equal values in a cluster, in another row order: the
    segment sort ranks them differently, the aggregate stays."""
    flat, labels, k = cluster_stack(7, [9, 6, 1, 4], 5, ties=True)
    flat[labels == 0] = np.round(flat[labels == 0])      # many exact ties
    perm = np.random.default_rng(8).permutation(len(labels))
    agg = tagg.make_aggregator(name, beta=0.25)
    a = agg(*both(flat, labels, k)[1])
    b = agg(*both(flat[perm], labels[perm], k)[1])
    if name == "median":
        assert torch.equal(a, b)
    else:
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6 * float(np.abs(flat).max()))


def test_small_clusters_reduce_to_the_mean():
    """Size-1 and size-2 clusters: the median and the trimmed mean give a
    and (a + b) / 2, as the mean does."""
    flat, labels, k = cluster_stack(9, [1, 2, 1, 2], 7, ties=False)
    _, t = both(flat, labels, k)
    mean = tagg.get_aggregator("mean")(*t)
    for name in ("median", "trimmed_mean"):
        got = tagg.make_aggregator(name, beta=0.45)(*t)
        np.testing.assert_allclose(got.numpy(), mean.numpy(), rtol=1e-6,
                                   atol=1e-6)


def tree_pair(seed):
    rng = np.random.default_rng(seed)
    tree = {"w": rng.normal(size=(30, 3, 4)).astype(np.float32),
            "b": rng.normal(size=(30, 5)).astype(np.float32)}
    labels = rng.integers(0, 4, size=30).astype(np.int32)
    labels[:4] = np.arange(4)
    return tree, labels


@pytest.mark.parametrize("name", ["mean", "trimmed_mean", "median",
                                  "geometric_median"])
@pytest.mark.parametrize("wrapper", ["cluster_reduce_tree",
                                     "cluster_aggregate_tree"])
def test_tree_wrappers_match_reference(name, wrapper):
    tree, labels = tree_pair(11)
    k = 4
    onehot = np.eye(k, dtype=np.float32)[labels]
    counts = onehot.sum(0)
    want = getattr(jagg, wrapper)(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(labels),
        jnp.asarray(onehot), jnp.asarray(counts), name)
    got = getattr(tagg, wrapper)(
        {key: torch.from_numpy(v) for key, v in tree.items()},
        torch.from_numpy(labels), torch.from_numpy(onehot),
        torch.from_numpy(counts), name)
    for key in tree:
        assert tuple(got[key].shape) == tuple(want[key].shape)
        close(got[key].numpy(), want[key], float(np.abs(tree[key]).max()))


@pytest.mark.parametrize("row", ["label -1", "soft row"])
@pytest.mark.parametrize("name", ["mean", "trimmed_mean", "median",
                                  "geometric_median"])
def test_aggregate_tree_gathers_back_as_the_reference_off_one_hot(name, row):
    """``onehot @ reduced``: a client with label -1 and an all-zero one-hot
    row gets zeros (no raise), a soft row the product, both as the
    reference computes them (its sort puts the -1 row first); the one-hot
    rows get their cluster's representative bit for bit."""
    tree, labels = tree_pair(12)
    k = 4
    onehot = np.eye(k, dtype=np.float32)[labels]
    if row == "label -1":
        labels[-1], onehot[-1] = -1, 0.0
    else:
        onehot[-1] = [0.5, 0.0, 0.25, 0.25]
    counts = onehot.sum(0)
    ttree = {key: torch.from_numpy(v) for key, v in tree.items()}
    t = (torch.from_numpy(labels), torch.from_numpy(onehot),
         torch.from_numpy(counts), name)
    got = tagg.cluster_aggregate_tree(ttree, *t)
    want = jagg.cluster_aggregate_tree(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(labels),
        jnp.asarray(onehot), jnp.asarray(counts), name)
    reps = tagg.cluster_reduce_tree(ttree, *t)
    for key in tree:
        close(got[key].numpy(), want[key], float(np.abs(tree[key]).max()))
        assert torch.equal(got[key][:-1],
                           reps[key][torch.from_numpy(labels[:-1]).long()])
        if row == "label -1":
            assert not got[key][-1].any()


def test_registry_and_make_aggregator_match_reference():
    assert tagg.list_aggregators() == jagg.list_aggregators()
    for name in tagg.list_aggregators():
        assert tagg.get_aggregator(name).breakdown == \
            jagg.get_aggregator(name).breakdown
    agg = tagg.make_aggregator("trimmed_mean", beta=0.2, iters=3, bogus=1,
                               eps=None)
    want = jagg.make_aggregator("trimmed_mean", beta=0.2, iters=3, bogus=1,
                                eps=None)
    assert (agg.name, agg.beta, agg.breakdown) == (want.name, want.beta,
                                                   want.breakdown)
    gm = tagg.make_aggregator("geometric_median", iters=3, beta=0.2)
    assert (gm.iters, gm.eps) == (3, 1e-8)
    assert tagg.make_aggregator("mean", beta=0.3) is tagg.get_aggregator(
        "mean")
    for bad in ({"beta": 0.5}, {"beta": -0.1}):
        with pytest.raises(ValueError, match="beta"):
            tagg.make_aggregator("trimmed_mean", **bad)
    with pytest.raises(ValueError, match="iters"):
        tagg.make_aggregator("geometric_median", iters=0)
    with pytest.raises(ValueError, match="eps"):
        tagg.make_aggregator("geometric_median", eps=0.0)
    with pytest.raises(KeyError, match="unknown aggregator"):
        tagg.get_aggregator("mode")
