"""The port's tree flattening and JL sketch against the JAX reference.

The port draws its projection from a ``torch.Generator``, which cannot
reproduce JAX's threefry draws, so the parity tests hand the reference's
projection across (``ref_projection`` below rebuilds exactly what
``repro.core.sketch.sketch_vector`` multiplies by: one
``normal(fold_in(PRNGKey(seed), i), (block, s))`` per block, the first n
rows, over sqrt(s)).  Tolerance: rtol 1e-5 / atol 1e-5 (fp32 products
summed in another order); past one 65 536-row block atol is 1e-5 of the
result's largest entry, since rounding there grows with the sum.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sketch import sketch_tree as jsketch_tree
from repro.utils import tree_to_vector as jtree_to_vector
from repro.utils import vector_to_tree as jvector_to_tree
from repro_torch.core import sketch as tsketch
from repro_torch.interop import params_from_numpy, projection_from_numpy
from repro_torch.utils import (
    tree_leaves,
    tree_map,
    tree_size,
    tree_to_matrix,
    tree_to_vector,
    vector_to_tree,
)


def ref_projection(seed: int, n: int, sketch_dim: int) -> np.ndarray:
    """The (n, sketch_dim) matrix the reference sketch multiplies by."""
    key = jax.random.PRNGKey(seed)
    block = max(256, min(1 << 16, ((n + 255) // 256) * 256))
    nb = -(-n // block)
    s = jnp.concatenate([
        jax.random.normal(jax.random.fold_in(key, i), (block, sketch_dim),
                          jnp.float32) for i in range(nb)])[:n]
    return np.asarray(s / jnp.sqrt(jnp.float32(sketch_dim)))


def mixed_tree(rng, lead=()):
    return {
        "w": rng.normal(size=lead + (3, 2)).astype(np.float32),
        "b": rng.normal(size=lead + (4,)).astype(np.float32),
        "block": {"z": rng.normal(size=lead + (2,)).astype(np.float32),
                  "a": rng.normal(size=lead + (1, 5)).astype(np.float32)},
        "emb": [rng.normal(size=lead + (3,)).astype(np.float32),
                rng.normal(size=lead + (2, 2)).astype(np.float32)],
    }


def test_tree_to_vector_follows_jax_order():
    tree = mixed_tree(np.random.default_rng(0))
    want = np.asarray(jtree_to_vector(jax.tree_util.tree_map(jnp.asarray,
                                                             tree)))
    got = tree_to_vector(params_from_numpy(tree, "cpu"))
    np.testing.assert_array_equal(got.numpy(), want)
    assert tree_size(params_from_numpy(tree, "cpu")) == want.size


def test_vector_to_tree_inverts_and_matches_jax():
    tree = mixed_tree(np.random.default_rng(1))
    ttree = params_from_numpy(tree, "cpu")
    vec = np.arange(tree_size(ttree), dtype=np.float32)
    got = vector_to_tree(torch.from_numpy(vec), ttree)
    want = jvector_to_tree(jnp.asarray(vec),
                           jax.tree_util.tree_map(jnp.asarray, tree))
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(tree_to_vector(got).numpy(), vec)
    with pytest.raises(ValueError):
        vector_to_tree(torch.zeros(3), ttree)


def test_tree_to_matrix_rows_are_client_vectors():
    stacked = params_from_numpy(mixed_tree(np.random.default_rng(2), (5,)),
                                "cpu")
    mat = tree_to_matrix(stacked)
    for i in range(5):
        row = tree_to_vector(tree_map(lambda l: l[i], stacked))
        np.testing.assert_array_equal(mat[i].numpy(), row.numpy())


@pytest.mark.parametrize("n,sketch_dim,seed", [(16, 64, 0), (300, 32, 3),
                                               (70_000, 8, 5)])
def test_sketch_with_the_reference_projection_matches(n, sketch_dim, seed):
    rng = np.random.default_rng(n)
    params = {"theta": rng.normal(size=(n,)).astype(np.float32)}
    want = np.asarray(jsketch_tree(jax.random.PRNGKey(seed),
                                   {"theta": jnp.asarray(params["theta"])},
                                   sketch_dim))
    proj = projection_from_numpy(ref_projection(seed, n, sketch_dim), "cpu")
    got = tsketch.sketch_tree(params_from_numpy(params, "cpu"), sketch_dim,
                              projection=proj)
    # each entry is an n-term fp32 dot product summed in another order
    # than XLA's: its rounding grows with the result's scale, so atol is
    # 1e-5 of the largest entry (1e-5 itself for the one-block cases)
    atol = 1e-5 * max(1.0, float(np.abs(want).max())) if n > 1 << 16 \
        else 1e-5
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=atol)


def test_stacked_sketch_matches_the_reference_per_client():
    rng = np.random.default_rng(7)
    stacked = mixed_tree(rng, (6,))
    n = sum(np.prod(l.shape[1:]) for l in jax.tree_util.tree_leaves(stacked))
    proj = projection_from_numpy(ref_projection(11, int(n), 16), "cpu")
    got = tsketch.sketch_stacked(params_from_numpy(stacked, "cpu"), proj)
    want = np.asarray(jax.vmap(
        lambda p: jsketch_tree(jax.random.PRNGKey(11), p, 16))(
            jax.tree_util.tree_map(jnp.asarray, stacked)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [16, 70_000])
def test_own_projection_is_the_blockwise_draw(n):
    vec = torch.from_numpy(np.random.default_rng(n).normal(size=n)
                           .astype(np.float32))
    proj = tsketch.jl_projection(n, 8, seed=4, device="cpu")
    assert tuple(proj.shape) == (n, 8)
    assert torch.equal(tsketch.sketch_vector(vec, 8, seed=4),
                       tsketch.sketch_vector(vec, 8, projection=proj))


def test_own_projection_is_n01_over_s():
    proj = tsketch.jl_projection(4096, 64, seed=0, device="cpu") * 8.0
    assert abs(float(proj.mean())) < 0.01
    assert abs(float(proj.var()) - 1.0) < 0.01
    again = tsketch.jl_projection(4096, 64, seed=0, device="cpu") * 8.0
    assert torch.equal(proj, again)


def test_sketch_checks_its_inputs():
    with pytest.raises(ValueError, match="seed= or projection="):
        tsketch.sketch_vector(torch.zeros(4), 8)
    with pytest.raises(ValueError, match="projection has"):
        tsketch.sketch_rows(torch.zeros((2, 4)), torch.zeros((5, 8)))
    with pytest.raises(ValueError, match="empty"):
        tsketch.sketch_stacked({}, torch.zeros((5, 8)))
