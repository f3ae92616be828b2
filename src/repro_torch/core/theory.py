"""Explicit theory quantities from Section 4 / Table 1 (a copy of
``repro/core/theory.py``; numpy).

These power ``benchmarks/table1_comparison.py`` and the threshold
verification tests: given problem constants they evaluate the paper's
sample requirements and communication costs for ODCL-CC, ODCL-KM, IFCA
and ALL-for-ALL.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ProblemConstants:
    """Constants appearing in M (proof of Theorem 1, Appendix B.1)."""
    L: float              # smoothness
    mu_F: float           # strong convexity of population losses
    R: float              # parameter-space radius (Assumption 2)
    d: int                # model dimension
    G_F: float            # population gradient bound
    N: float = 1.0        # Assumption 6 gradient bound at optima
    F_star: float = 0.0   # population loss value at optimum
    beta: float = 2.0     # free parameter (Remark 10)


def constant_M(c: ProblemConstants) -> float:
    """M_k of Appendix B.1 (max over the per-user constants M_ik)."""
    log2 = np.log(2.0)
    t1 = 16 * c.L * c.F_star * (log2 + c.beta) / c.mu_F ** 2
    t2 = 64 * c.R ** 2 * c.L * (log2 + c.d * np.log(6 * c.R) + (c.d + 1) * c.beta) / c.mu_F
    t3 = 16 * c.R * c.N * (log2 + c.beta) / c.mu_F
    t4 = (2 * c.G_F + 16 * c.R * c.L * (1 + log2 + c.d * np.log(6 * c.R) + (c.d + 1) * c.beta)) / c.mu_F
    return t1 + t2 + t3 + t4


def sample_threshold(M: float, alpha: float, D: float, gamma: float) -> float:
    """Theorem 1 threshold: smallest n with n/log n > 4 M alpha^2/(D-2gamma)^2."""
    rhs = 4.0 * M * alpha ** 2 / (D - 2 * gamma) ** 2
    n = max(3.0, rhs)
    # solve n / log n > rhs by doubling + bisection
    while n / np.log(n) <= rhs:
        n *= 2.0
    lo, hi = n / 2.0, n
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if mid > 3 and mid / np.log(mid) > rhs:
            hi = mid
        else:
            lo = mid
    return hi


def threshold_odcl_cc(M: float, m: int, c_min: int, D: float, gamma: float) -> float:
    """Section 4.2: n/log n > 64 M (m-|C_(K)|)^2 / (|C_(K)|^2 (D-2g)^2)."""
    alpha = 4.0 * (m - c_min) / c_min
    return sample_threshold(M, alpha, D, gamma)


def threshold_odcl_km(M: float, m: int, c_min: int, D: float, gamma: float,
                      c: float = 1.0) -> float:
    """Section 4.2: n/log n > 16 M (|C_(K)|+c sqrt m)^2/(|C_(K)|^2 (D-2g)^2)."""
    alpha = 2.0 + 2.0 * c * np.sqrt(m) / c_min
    return sample_threshold(M, alpha, D, gamma)


def ifca_comm_rounds(kappa: float, p: float, D: float, eps: float) -> float:
    """IFCA round count T = (8 kappa / p) log(2D/eps) (Section 4.3)."""
    return 8.0 * kappa / p * np.log(2.0 * D / eps)


def all_for_all_comm_rounds(n: int, m: int, K: int) -> float:
    """ALL-for-ALL: Theta((nm/K) log(nm/K)) (Table 1)."""
    x = n * m / K
    return x * np.log(x)


def communication_saving(kappa: float, p: float, D: float, eps: float) -> float:
    """ODCL saves a factor O((kappa/p) log(2D/eps)) vs IFCA (contribution 3)."""
    return ifca_comm_rounds(kappa, p, D, eps) / 1.0


def mse_bound_theorem1(c: ProblemConstants, n: int, K: int, c_k: int,
                       c_min: int, E_k: float, E_tilde: float,
                       gamma: float, m: int) -> float:
    """The dominating explicit terms of Theorem 1's MSE bound."""
    t1 = 2 * E_k / (n * c_k)
    t2 = 8 * K * E_tilde * c.R ** 2 / (n * c_min * gamma ** 2)
    t3 = 8 * m * c.R ** 2 / n ** c.beta
    return t1 + t2 + t3


def merge_condition(n_i: int, n_j: int) -> float:
    """Appendix F: merging clusters i,j is beneficial when
    D^2 <= min(n_i,n_j) / (max(n_i,n_j) (n_i+n_j)); returns the bound."""
    return min(n_i, n_j) / (max(n_i, n_j) * (n_i + n_j))
