"""The port's group-prox (row-wise L2-ball projection) and batched
pairwise distances against the JAX reference's kernels.

On the CPU ``kernels.ops`` runs the plain PyTorch versions; they are held
to the reference's jnp oracles (``repro.kernels.ref``) and to the Pallas
kernels run in interpret mode, on the same numpy inputs, over the shape
and edge-case grid of the chip check at small sizes: e in {1, 7, 1031},
d in {1, 16, 32, 200}, b in {1, 3}, zero rows, rows exactly on the
sphere, inert (r = 0) slots, scalar / per-row / per-rung radii, e = 0.
Tolerance: rtol 1e-6 / atol 1e-7 * ||v|| per element (the row norm is an
fp32 sum taken in another order); distances rtol 1e-5 / atol 1e-4.
"""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.group_prox import (
    group_ball_proj_batched_pallas,
    group_ball_proj_pallas,
)
from repro.kernels.pairwise_l2 import pairwise_sqdist_pallas
from repro_torch import runtime
from repro_torch.kernels import group_prox as tprox
from repro_torch.kernels import ops


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One host thread: the tensors here are small, and parallel test
    workers must not oversubscribe the CPU."""
    with runtime.pinned_threads(1):
        yield


def prox_rows(seed, b, e, d):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(b, e, d)).astype(np.float32)
    norms = np.sqrt((v.astype(np.float64) ** 2).sum(-1)).astype(np.float32)
    r = (np.abs(rng.normal(size=(b, e))) * norms).astype(np.float32)
    r[:, ::5] = norms[:, ::5]            # on the sphere
    r[:, 1::7] = 0.0                     # inert slots
    v[:, 2::11] = 0.0                    # zero rows
    return v, r


def assert_prox_close(got, want, v):
    got, want = np.asarray(got), np.asarray(want)
    norms = np.sqrt((np.asarray(v, np.float64) ** 2).sum(-1, keepdims=True))
    assert np.all(np.abs(got - want) <= 1e-6 * np.abs(want) + 1e-7 * norms)


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("e", [1, 7, 1031])
@pytest.mark.parametrize("d", [1, 16, 32, 200])
def test_batched_prox_matches_reference(b, e, d):
    v, r = prox_rows(b * 10000 + e * 10 + d, b, e, d)
    got = ops.group_ball_proj_batched(torch.from_numpy(v), torch.from_numpy(r))
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, e, d)
    assert_prox_close(got, jref.group_ball_proj_batched(jnp.asarray(v),
                                                        jnp.asarray(r)), v)
    assert_prox_close(got, group_ball_proj_batched_pallas(
        jnp.asarray(v), jnp.asarray(r), interpret=True), v)


@pytest.mark.parametrize("e,d", [(1, 1), (7, 16), (1031, 32), (7, 200)])
@pytest.mark.parametrize("per_row", [False, True])
def test_prox_matches_reference(e, d, per_row):
    v, r = prox_rows(e + d, 1, e, d)
    v, r = v[0], r[0]
    radius = r if per_row else np.float32(0.75)
    got = ops.group_ball_proj(torch.from_numpy(v),
                              torch.from_numpy(np.asarray(radius)))
    assert_prox_close(got, jref.group_ball_proj(jnp.asarray(v), radius), v)
    assert_prox_close(got, group_ball_proj_pallas(
        jnp.asarray(v), jnp.asarray(radius), interpret=True), v)
    # a Python float radius is the same scalar
    if not per_row:
        assert torch.equal(ops.group_ball_proj(torch.from_numpy(v), 0.75), got)


def test_prox_radius_per_rung_broadcasts_like_the_reference():
    v, _ = prox_rows(5, 3, 40, 8)
    rung = np.array([[0.1], [1.0], [10.0]], np.float32)     # (b, 1)
    got = ops.group_ball_proj_batched(torch.from_numpy(v),
                                      torch.from_numpy(rung))
    assert_prox_close(got, jref.group_ball_proj_batched(
        jnp.asarray(v), jnp.asarray(np.broadcast_to(rung, (3, 40)))), v)


def test_prox_edge_cases_are_exact():
    # a row on the sphere, a zero row, an inert slot, a row inside
    v = np.array([[3.0, 4.0], [0.0, 0.0], [1.0, 1.0], [0.3, 0.4]], np.float32)
    r = np.array([5.0, 0.0, 0.0, 1.0], np.float32)
    got = ops.group_ball_proj(torch.from_numpy(v), torch.from_numpy(r))
    want = np.asarray(jref.group_ball_proj(jnp.asarray(v), r))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[[0, 3]], v[[0, 3]])
    assert not got.numpy()[[1, 2]].any()


def test_empty_edge_sets_return_empty_results():
    ops.reset_launch_counts()
    out = ops.group_ball_proj_batched(torch.zeros((2, 0, 5)),
                                      torch.zeros((2, 0)))
    assert tuple(out.shape) == (2, 0, 5)
    want = group_ball_proj_batched_pallas(jnp.zeros((2, 0, 5)),
                                          jnp.zeros((2, 0)), interpret=True)
    assert tuple(out.shape) == want.shape
    assert tuple(ops.group_ball_proj(torch.zeros((0, 5)), 1.0).shape) == (0, 5)
    # the CPU runs the plain versions: no kernel launch is counted
    assert ops.launch_counts()["group_ball_proj_batched"] == 0
    assert ops.launch_counts()["group_ball_proj"] == 0


def test_group_prox_module_has_no_switch_and_no_fallback():
    tree = ast.parse(Path(tprox.__file__).read_text())
    for node in ast.walk(tree):
        assert not isinstance(node, ast.Try)
        assert not (isinstance(node, (ast.Attribute, ast.Name))
                    and getattr(node, "attr", getattr(node, "id", ""))
                    in ("environ", "getenv"))


def test_cuda_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        tprox.group_ball_proj(torch.zeros((3, 4)), 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        tprox.group_ball_proj_batched(torch.zeros((1, 3, 4)), 1.0)


@pytest.mark.parametrize("nb,m,k,d", [(1, 1, 1, 1), (4, 8, 24, 5),
                                      (16, 64, 192, 32), (3, 7, 2, 130)])
def test_batched_pairwise_matches_vmapped_reference(nb, m, k, d):
    rng = np.random.default_rng(nb * 100 + m + k + d)
    a = rng.normal(size=(nb, m, d)).astype(np.float32)
    b = rng.normal(size=(nb, k, d)).astype(np.float32)
    got = ops.pairwise_sqdist(torch.from_numpy(a), torch.from_numpy(b))
    assert tuple(got.shape) == (nb, m, k)
    want = np.asarray(jax.vmap(jref.pairwise_sqdist)(jnp.asarray(a),
                                                     jnp.asarray(b)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    pallas = np.asarray(jax.vmap(
        lambda x, y: pairwise_sqdist_pallas(x, y, interpret=True))(
            jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-5, atol=1e-4)


def test_batched_pairwise_keeps_far_pads_out_of_the_nearest():
    # the LSH windows pad with rows at 1e30: their distances must come out
    # inf (not NaN) against real rows, so a mask-then-top-k never picks them
    rng = np.random.default_rng(0)
    a = rng.normal(size=(2, 4, 8)).astype(np.float32)
    b = np.concatenate([rng.normal(size=(2, 3, 8)),
                        np.full((2, 2, 8), 1e30)], axis=1).astype(np.float32)
    got = ops.pairwise_sqdist(torch.from_numpy(a), torch.from_numpy(b))
    assert np.isinf(got.numpy()[:, :, 3:]).all()
    assert np.isfinite(got.numpy()[:, :, :3]).all()
