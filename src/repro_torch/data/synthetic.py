"""Clustered synthetic federations, the paper's data-generating processes
(the port of ``repro/data/synthetic.py``; numpy, the same draws in the
same order as the reference, so a federation without a scenario is the
reference's bit for bit).

Section 5 linear regression: y = <x, u*_k> + eps, eps ~ N(0,1); K = 10
clusters, d = 20; x has 5 random nonzero N(0,1) components; cluster
optima drawn from the staggered uniform intervals of Appendix E.1.

Appendix E.2 logistic regression: y = 2 Bernoulli(sigmoid(<x, th*_k> +
b*_k)) - 1 with per-cluster Gaussian covariate covariances.

Table 2 "MNIST" stand-in: a two-class Gaussian-blob "digit" problem where
the second cluster flips the labels (the paper's opposite-preference
scenario), matched in size (m=100, K=2, n=4 points/user).

A scenario's hooks draw from the port's keyed draws (``utils/prng.py``),
not the reference's, and run on the CPU: their draws are the same on
every device, and the federation is numpy.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.scenarios import build_scenario
from repro_torch.utils import prng


@dataclasses.dataclass
class Federation:
    """Per-user datasets + ground truth for a clustered DL system."""
    xs: np.ndarray            # (m, n, d) covariates per user
    ys: np.ndarray            # (m, n) responses per user
    true_labels: np.ndarray   # (m,) true cluster of each user
    optima: np.ndarray        # (K, d[+1]) population-optimal models
    D: float                  # min pairwise separation of the optima
    xs_test: np.ndarray | None = None
    ys_test: np.ndarray | None = None
    honest: np.ndarray | None = None   # (m,) bool; None = all honest

    @property
    def m(self) -> int:
        return self.xs.shape[0]

    @property
    def n(self) -> int:
        return self.xs.shape[1]

    @property
    def K(self) -> int:
        return self.optima.shape[0]


def paper_synthetic_optima(rng: np.random.Generator, d: int = 20) -> np.ndarray:
    """Appendix E.1 optima: u*_{k,i} ~ U([3k-2, 3k-1]) for k=1..5 and the
    mirrored negative intervals for k=6..10 -> K=10, guaranteed D > 0."""
    lows = np.array([1, 4, 7, 10, 13, -2, -5, -8, -11, -14], float)
    highs = np.array([2, 5, 8, 11, 14, -1, -4, -7, -10, -13], float)
    lo = np.minimum(lows, highs)
    hi = np.maximum(lows, highs)
    return rng.uniform(lo[:, None], hi[:, None], size=(10, d))


def _sparse_gaussian_x(rng, n, d, nnz=5):
    """Covariates with ``nnz`` random N(0,1) components, rest zero."""
    x = np.zeros((n, d), np.float32)
    for row in range(n):
        idx = rng.choice(d, size=nnz, replace=False)
        x[row, idx] = rng.normal(size=nnz)
    return x


def min_separation(optima: np.ndarray) -> float:
    diff = optima[:, None] - optima[None, :]
    dist = np.sqrt((diff ** 2).sum(-1))
    np.fill_diagonal(dist, np.inf)
    return float(dist.min())


def make_linear_regression_federation(
    seed: int, m: int = 100, K: int = 10, n: int = 100, d: int = 20,
    noise_std: float = 1.0, optima: np.ndarray | None = None,
    scenario=None,
) -> Federation:
    """Section 5 synthetic setup. Balanced clusters |C_k| = m/K.

    ``scenario`` (a name, '+'-composed spec, or ``Scenario`` instance
    from ``repro_torch.scenarios``) reshapes the federation adversarially:
    its ``population``/``wave_labels`` hooks replace the balanced
    round-robin occupancy (longtail Zipf, mid-stream drift — the
    effective labels ARE the recorded truth), ``honest_mask`` is stored
    on ``Federation.honest``, and ``corrupt_uploads`` is applied to the
    (m, n) response matrix — the ridge ERM is linear in y, so the
    sign-flip attack on responses produces exactly the sign-flipped
    model upload (the noise attack becomes response poisoning).
    """
    rng = np.random.default_rng(seed)
    if optima is None:
        if K == 10:
            optima = paper_synthetic_optima(rng, d)
        else:
            # staggered intervals like E.3: U([k, k+1]) alternating sign
            lows = np.array([(k // 2 + k % 2) * (1 if k % 2 == 0 else -1) - (1 if k % 2 else 0)
                             for k in range(K)], float)
            optima = rng.uniform(lows[:, None], lows[:, None] + 1.0, size=(K, d))
    honest = None
    scen = None
    if scenario is None:
        assert m % K == 0, "balanced clustering requires K | m"
        per = m // K
        true_labels = np.repeat(np.arange(K), per)
    else:
        scen = build_scenario(scenario)
        skey = prng.key(seed)
        labels = scen.population(skey, m, K, device="cpu")
        labels = scen.wave_labels(skey, labels, 0, m, K)
        true_labels = labels.numpy().astype(np.int64)
        honest = scen.honest_mask(skey, m, device="cpu").numpy()
    xs = np.zeros((m, n, d), np.float32)
    ys = np.zeros((m, n), np.float32)
    for i in range(m):
        k = true_labels[i]
        x = _sparse_gaussian_x(rng, n, d)
        eps = rng.normal(scale=noise_std, size=n)
        xs[i] = x
        ys[i] = x @ optima[k] + eps
    if scen is not None:
        ys = scen.corrupt_uploads(
            prng.key(seed), torch.from_numpy(ys),
            torch.from_numpy(true_labels), 0, m).numpy().astype(np.float32)
    return Federation(xs=xs, ys=ys, true_labels=true_labels,
                      optima=optima.astype(np.float32),
                      D=min_separation(optima), honest=honest)


def make_logistic_federation(
    seed: int, m: int = 100, K: int = 4, n: int = 1000, d: int = 2,
) -> Federation:
    """Appendix E.2 logistic setup (K=4, d=2, per-cluster covariances)."""
    rng = np.random.default_rng(seed)
    thetas = np.array([[1, -1], [1, 0], [-1, 1], [0, -1]], np.float32)[:K]
    covs = [np.eye(2), np.array([[2, 1], [1, 2.]]),
            np.array([[1, .5], [.5, 1.]]), np.array([[2, 0], [0, 2.]])][:K]
    assert m % K == 0
    per = m // K
    true_labels = np.repeat(np.arange(K), per)
    xs = np.zeros((m, n, d), np.float32)
    ys = np.zeros((m, n), np.float32)
    for i in range(m):
        k = true_labels[i]
        x = rng.multivariate_normal(np.zeros(d), covs[k], size=n)
        p = 1.0 / (1.0 + np.exp(-(x @ thetas[k])))
        y = 2.0 * (rng.uniform(size=n) < p) - 1.0
        xs[i] = x
        ys[i] = y
    # optima include the zero intercept as last component
    optima = np.concatenate([thetas, np.zeros((K, 1), np.float32)], axis=1)
    return Federation(xs=xs, ys=ys, true_labels=true_labels, optima=optima,
                      D=min_separation(thetas))


def make_mnist_like_federation(
    seed: int, m: int = 100, n: int = 4, d: int = 20, sep: float = 2.0,
    n_test: int = 200,
) -> Federation:
    """Table 2 stand-in: binary '1 vs 2' blobs; cluster 2 flips labels.

    Each user gets n=4 points (two per class) as in the paper.  Test
    sets are per-user draws from the same cluster distribution.
    """
    rng = np.random.default_rng(seed)
    mu1 = rng.normal(size=d); mu1 *= sep / np.linalg.norm(mu1)
    mu2 = -mu1
    assert m % 2 == 0
    true_labels = np.repeat(np.arange(2), m // 2)

    def draw(n_pts, flip):
        half = n_pts // 2
        xa = mu1 + rng.normal(scale=1.0, size=(half, d))
        xb = mu2 + rng.normal(scale=1.0, size=(n_pts - half, d))
        x = np.concatenate([xa, xb]).astype(np.float32)
        y = np.concatenate([np.ones(half), -np.ones(n_pts - half)]).astype(np.float32)
        if flip:
            y = -y
        perm = rng.permutation(n_pts)
        return x[perm], y[perm]

    xs = np.zeros((m, n, d), np.float32); ys = np.zeros((m, n), np.float32)
    xs_t = np.zeros((m, n_test, d), np.float32); ys_t = np.zeros((m, n_test), np.float32)
    for i in range(m):
        flip = bool(true_labels[i])
        xs[i], ys[i] = draw(n, flip)
        xs_t[i], ys_t[i] = draw(n_test, flip)
    # population optima of the logistic problem are +/- c*mu1 direction;
    # report the Bayes direction with unit intercept slot
    w = (mu1 - mu2).astype(np.float32)
    optima = np.stack([np.append(w, 0.0), np.append(-w, 0.0)])
    return Federation(xs=xs, ys=ys, true_labels=true_labels, optima=optima,
                      D=float(np.linalg.norm(2 * w)), xs_test=xs_t, ys_test=ys_t)
