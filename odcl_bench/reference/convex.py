"""ODCL-CC's clustering step in plain PyTorch: convex clustering
(sum-of-norms, the paper's eq. (4)) on the complete fusion graph, solved
by AMA (Chi & Lange 2015) with the dual step eta = 1/m, then the
clusters as the connected components of the pairs whose fused points
lie within ``merge_tol`` of each other.

The stop rule is the one the paper's solver uses: at most ``iters``
iterations, and stop after the first whose largest dual step, over eta,
is at most ``tol (1 + max |a|)``.  ``merge_tol`` is ``max(1e-6, 1e-3
diameter)`` of the fused points, the diameter being the largest distance
from their mean.
"""
from __future__ import annotations

import torch

from odcl_bench.reference import precision, rel_err


def _edges(m: int, device) -> tuple:
    i, j = torch.triu_indices(m, m, 1, device=device)
    return i, j


def ama(a: torch.Tensor, lam: float, *, iters: int, tol: float,
        prec: str = "fp64") -> tuple:
    """The AMA fixed point of sum-of-norms clustering of the rows of
    ``a`` (m, s) at penalty ``lam`` (unit weights, complete graph).
    Returns ``(u (m, s), iterations run)``."""
    with precision(prec) as dtype:
        a = a.to(dtype)
        m, s = a.shape
        i, j = _edges(m, a.device)
        eta = 1.0 / m
        thresh = tol * (1.0 + float(a.abs().max()))
        nu = torch.zeros((i.shape[0], s), dtype=dtype, device=a.device)

        def u_of(nu):
            u = a.clone()
            u.index_add_(0, i, nu)
            u.index_add_(0, j, nu, alpha=-1.0)
            return u

        n_iter = 0
        for _ in range(iters):
            u = u_of(nu)
            v = nu - eta * (u[i] - u[j])
            norms = torch.linalg.vector_norm(v, dim=1, keepdim=True)
            v = torch.where(norms > lam, v * (lam / norms.clamp_min(1e-30)), v)
            moved = float((v - nu).abs().max()) / eta
            nu = v
            n_iter += 1
            if moved <= thresh:
                break
        return u_of(nu), n_iter


def components(u: torch.Tensor) -> torch.Tensor:
    """The connected components of the pairs of rows of ``u`` within
    ``merge_tol`` of each other (the fused pairs), as a label per row:
    the smallest row index of its component."""
    m = u.shape[0]
    u = u.to(torch.float64)
    centred = u - u.mean(dim=0, keepdim=True)
    diam = float(torch.linalg.vector_norm(centred, dim=1).max()) + 1e-12
    tol = max(1e-6, 1e-3 * diam)
    sq = (u * u).sum(dim=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (u @ u.T)
    adj = d2 <= tol * tol
    lab = torch.arange(m, device=u.device)
    while True:
        new = torch.where(adj, lab[None, :], m).min(dim=1).values
        new = torch.minimum(new, lab)
        if torch.equal(new, lab):
            return lab
        lab = new


def cluster(a: torch.Tensor, lam: float, *, iters: int, tol: float,
            prec: str = "fp64") -> dict:
    """The whole clustering step: ``labels`` (m,) in [0, K') numbered by
    each cluster's first row, ``centers`` (K', s) the mean fused point of
    each, and ``n_iter``."""
    u, n_iter = ama(a, lam, iters=iters, tol=tol, prec=prec)
    roots = components(u)
    uniq, labels = torch.unique(roots, return_inverse=True)
    with precision(prec) as dtype:
        onehot = torch.nn.functional.one_hot(labels, uniq.numel()).to(dtype)
        centers = (onehot.T @ u.to(dtype)) / onehot.sum(dim=0)[:, None]
    return {"labels": labels, "centers": centers, "n_iter": n_iter}


def judge(a: torch.Tensor, labels: torch.Tensor, centers: torch.Tensor,
          cfg: dict, lam, warm: bool = False) -> tuple:
    """ODCL-CC's partition against the reference's AMA over the fp64
    sketches ``a``: ``partition_miss`` is 0 exactly when the two
    partitions are the same (the distinct (served, reference) label
    pairs, less the clusters of each side), and ``center_err`` compares
    each served center with the reference's center of the same
    clients (a warm AMA ends at the same partition).  Returns
    ``(numbers, {"n_iter": the reference's AMA iterations})``."""
    ref = cluster(a, lam, iters=cfg["algo_options"]["iters"],
                  tol=cfg["ama_tol"])
    rl = ref["labels"].to(labels.device)
    k_ref = int(ref["centers"].shape[0])
    pairs = torch.unique(labels * k_ref + rl)
    n_served = int(torch.unique(labels).numel())
    miss = 2 * int(pairs.numel()) - n_served - k_ref
    # each served cluster's reference cluster: that of its first client
    first = torch.full((int(centers.shape[0]),), labels.numel(),
                       dtype=torch.long, device=labels.device)
    first.scatter_reduce_(0, labels, torch.arange(labels.numel(),
                                                  device=labels.device),
                          reduce="amin")
    return ({"partition_miss": miss,
             "center_err": rel_err(centers, ref["centers"][rl[first]])},
            {"n_iter": ref["n_iter"]})


def control(a: torch.Tensor, cfg: dict, lam, generator, prec: str) -> tuple:
    """The control's clustering: :func:`cluster` in ``prec`` (the AMA
    draws nothing, so ``generator`` is unused); returns ``(labels,
    centers)``."""
    res = cluster(a, lam, iters=cfg["algo_options"]["iters"],
                  tol=cfg["ama_tol"], prec=prec)
    return res["labels"], res["centers"]
