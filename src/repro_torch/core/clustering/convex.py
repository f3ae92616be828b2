"""Convex (sum-of-norms) clustering, the ODCL-CC server step, with host
cluster extraction (the port of ``repro/core/clustering/convex.py``).

Solves the paper's problem (16)

    min_U  1/2 sum_i ||a_i - u_i||^2  +  lambda * sum_{i<j} w_ij ||u_i - u_j||

by the AMA splitting of Chi & Lange (2015) over the complete graph:

    u_i   = a_i + sum_{l: i=head(l)} nu_l - sum_{l: i=tail(l)} nu_l
    nu_l <- Proj_{||.|| <= lambda w_l} ( nu_l - eta (u_head - u_tail) )

with eta = 1/m, for a fixed number of iterations.  The projection is
the unbatched group-prox kernel (``kernels.ops.group_ball_proj``); with
uniform weights its radius is the scalar lambda.  Clusters (u_i == u_j up
to a tolerance, decided by ``engine.device_convex.fused_adjacency``)
come from a NumPy union-find on the host.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.engine.device_convex import fused_adjacency
from repro_torch.core.engine.segment import segment_plan, segment_sum
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops


class ConvexClusteringResult(NamedTuple):
    labels: np.ndarray        # (m,) int cluster ids (host)
    centers: np.ndarray       # (K', d) cluster centroids of the u's
    u: torch.Tensor           # (m, d) final fused representatives
    n_clusters: int
    lam: float


def _ama_solve(a, lam: float, weights=None, iters: int = 300):
    """Run AMA for ``iters`` iterations; returns final u (m,d) and duals
    (E,d).  ``weights=None`` is the uniform graph (scalar radius)."""
    a = a.to(torch.float32)
    m, d = a.shape
    iu = torch.triu_indices(m, m, 1, device=a.device)
    i_idx, j_idx = iu[0], iu[1]
    e = i_idx.shape[0]
    nu = a.new_zeros((e, d))
    eta = torch.tensor(1.0 / m, dtype=torch.float32, device=a.device)
    lam = torch.tensor(lam, dtype=torch.float32, device=a.device)
    radius = lam if weights is None else lam * torch.as_tensor(weights).to(
        a.device, torch.float32)
    heads = segment_plan(i_idx, m)
    tails = segment_plan(j_idx, m)

    def u_of(nu):
        return a + (segment_sum(nu, heads) - segment_sum(nu, tails))

    for _ in range(iters):
        u = u_of(nu)
        grad = u[i_idx] - u[j_idx]                       # (e, d)
        nu = kops.group_ball_proj(nu - eta * grad, radius)
    return u_of(nu), nu


def _connected_components(adj: np.ndarray) -> np.ndarray:
    """Union-find over a boolean adjacency matrix -> labels (m,)."""
    m = adj.shape[0]
    parent = np.arange(m)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    ii, jj = np.nonzero(np.triu(adj, k=1))
    for x, y in zip(ii, jj):
        rx, ry = find(x), find(y)
        if rx != ry:
            parent[ry] = rx
    roots = np.array([find(x) for x in range(m)])
    _, labels = np.unique(roots, return_inverse=True)
    return labels.astype(np.int32)


def convex_clustering(points, lam: float, *, iters: int = 300,
                      weights=None, merge_tol: float = None,
                      device=None) -> ConvexClusteringResult:
    """Solve (16) and extract the induced clustering.

    Args:
      points: (m, d) client model vectors (a tensor is used on its
        device; anything else goes to ``device``, CUDA unless "cpu").
      lam: the fusion penalty.
      iters: AMA iterations (a fixed count).
      weights: optional (E,) edge weights in upper-triangular order
        (uniform = 1, the paper's choice, when None).
      merge_tol: fuse u_i, u_j into one cluster when ||u_i-u_j|| <= tol;
        defaults to 1e-3 of the fused points' diameter (at least 1e-6).
    """
    if not isinstance(points, torch.Tensor):
        points = torch.as_tensor(np.asarray(points)).to(resolve_device(device))
    u, _ = _ama_solve(points, float(lam), weights, iters=iters)
    u_np = u.cpu().numpy()
    if merge_tol is None:
        diam = float(np.max(np.linalg.norm(
            u_np - u_np.mean(0, keepdims=True), axis=1))) + 1e-12
        merge_tol = max(1e-6, 1e-3 * diam)
    adj = fused_adjacency(u, torch.tensor(merge_tol, dtype=torch.float32,
                                          device=u.device)).cpu().numpy()
    labels = _connected_components(adj)
    n_clusters = int(labels.max()) + 1
    centers = np.stack([u_np[labels == c].mean(axis=0)
                        for c in range(n_clusters)])
    return ConvexClusteringResult(labels=labels, centers=centers, u=u,
                                  n_clusters=n_clusters, lam=float(lam))


def knn_weights(points, k: int = 5, phi: float = 0.5) -> torch.Tensor:
    """Gaussian kNN edge weights for weighted convex clustering (Remark 13):
    w_ij = exp(-phi ||a_i - a_j||^2) if j in kNN(i) or i in kNN(j), else
    0, in the solver's (E,) upper-triangular edge order, on the points'
    device."""
    points = torch.as_tensor(points).to(torch.float32)
    m = points.shape[0]
    d2 = kops.pairwise_sqdist(points, points).cpu().numpy()
    np.fill_diagonal(d2, np.inf)
    knn_idx = np.argsort(d2, axis=1)[:, :k]
    mask = np.zeros((m, m), bool)
    rows = np.repeat(np.arange(m), k)
    mask[rows, knn_idx.ravel()] = True
    mask |= mask.T
    iu, ju = np.triu_indices(m, k=1)
    w = np.where(mask[iu, ju], np.exp(-phi * d2[iu, ju]), 0.0)
    return torch.as_tensor(w, dtype=torch.float32).to(points.device)


def lambda_interval(points, labels) -> tuple[float, float]:
    """Recovery interval (17) for a candidate clustering:

    [ max_k diam(V_k)/|V_k| ,  min_{k!=l} ||c_k - c_l|| / (2n - |V_k| - |V_l|) )

    Returns (lo, hi); the interval is non-empty iff lo < hi.  Host NumPy
    in float64."""
    if isinstance(points, torch.Tensor):
        points = points.cpu().numpy()
    points = np.asarray(points, np.float64)
    labels = np.asarray(labels)
    n = points.shape[0]
    ks = np.unique(labels)
    lo = 0.0
    cents, sizes = [], []
    for k in ks:
        pk = points[labels == k]
        sizes.append(len(pk))
        cents.append(pk.mean(axis=0))
        if len(pk) > 1:
            # the largest pairwise distance, 256 rows at a time
            d2max = 0.0
            for s in range(0, len(pk), 256):
                blk = pk[s:s + 256]
                d2 = ((blk[:, None] - pk[None, :]) ** 2).sum(-1)
                d2max = max(d2max, float(d2.max()))
            diam = float(np.sqrt(d2max))
        else:
            diam = 0.0
        lo = max(lo, diam / len(pk))
    hi = np.inf
    for a in range(len(ks)):
        for b in range(a + 1, len(ks)):
            dist = float(np.linalg.norm(cents[a] - cents[b]))
            hi = min(hi, dist / (2 * n - sizes[a] - sizes[b]))
    if len(ks) == 1:
        hi = np.inf
    return lo, hi


def clusterpath(points, *, n_lambdas: int = 10, iters: int = 300,
                grow: float = 1.25, lam_init: float = 0.1,
                max_probe: int = 60, device=None):
    """The Appendix B.3 / E.3 clusterpath heuristic for choosing lambda.

    Probes lambda until K_{lam_1} = m (all singletons) and K_{lam_N} = 1,
    sweeps ``n_lambdas`` equidistant values in between, and picks the
    clustering recovered by the most lambdas, a lambda that verifies the
    recovery interval (17) breaking ties, then K' > 1.  Returns
    ``(best, results)``."""
    if not isinstance(points, torch.Tensor):
        points = torch.as_tensor(np.asarray(points)).to(resolve_device(device))
    m = points.shape[0]
    host_points = points.cpu().numpy()

    def solve(lam):
        return convex_clustering(points, lam, iters=iters)

    lam_lo = lam_hi = lam_init
    r = solve(lam_lo)
    probes = 0
    while r.n_clusters < m and probes < max_probe:
        lam_lo /= grow
        r = solve(lam_lo)
        probes += 1
    r = solve(lam_hi)
    while r.n_clusters > 1 and probes < max_probe:
        lam_hi *= grow
        r = solve(lam_hi)
        probes += 1

    lams = np.linspace(lam_lo, lam_hi, n_lambdas)
    results, verified = [], []
    for lam in lams:
        res = solve(float(lam))
        lo, hi = lambda_interval(host_points, res.labels)
        results.append(res)
        verified.append(lo <= lam < hi)

    counts: dict = {}
    for res in results:
        counts[res.n_clusters] = counts.get(res.n_clusters, 0) + 1
    best = max(
        zip(results, verified),
        key=lambda rv: (counts[rv[0].n_clusters], rv[1], rv[0].n_clusters > 1),
    )[0]
    return best, results
