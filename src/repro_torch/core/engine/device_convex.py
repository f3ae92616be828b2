"""Device convex clustering, ODCL-CC on the port's device (the port of
``repro/core/engine/device_convex.py``).

  * ``_ama_fixed_point`` — the Chi & Lange (2015) AMA splitting over an
    edge list, batched over a leading lambda axis (the clusterpath ladder
    advances its L solves together).  An iteration is two passes over
    the (L, E, d) dual and writes no edge-sized temporary: ``u`` gathered
    back from the dual by the deterministic segment kernel
    (``kernels.ops.ama_gather_back``, over ``engine/segment.py``'s plans),
    then the group-prox kernel's fused step
    (``kernels.ops.group_ball_proj_batched`` with the step's operands:
    the edge difference, the gradient step, the prox and the largest
    dual step), which updates the one dual buffer in place.  The loop
    reads the dual step ``moved`` once per iteration on the host and
    stops at the reference's condition, so it reports the reference's
    ``n_iter`` (counter ``convex.ama.iterations``).
  * the fusion graph is a registered edge set (``engine/edges.py``):
    ``"complete"``, ``"knn"`` or ``"knn-approx"``.
  * cluster extraction is min-label propagation over the fused pairs
    (||u_i - u_j|| <= merge_tol): the dense (m, m) form on the complete
    graph, the edge list otherwise; one host read per step (counter
    ``convex.components.steps``).
  * ``device_convex_cluster`` / ``device_clusterpath`` — fixed lambda and
    the K-free lambda ladder.  Labels are fusion-graph root ids in
    [0, m) and ``centers`` is root-indexed ((m, d), zero rows for
    non-roots), as in the reference.

Under a mesh the registry's convex families (``clustering/api.py``)
gather the (C, sketch_dim) sketch to every rank first (4 MB at
C = 16 384, sketch 64) and run the AMA, the group-prox kernels and the
kNN tiles replicated; each rank's rows then take their labels from the
replicated result, and only the parameter mean is sharded.  The edge
axis is not sharded (ROADMAP queue A).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import obs
from repro_torch.core.engine.edges import Edges, get_edge_set
from repro_torch.core.engine.segment import segment_plan, segment_sum
from repro_torch.kernels import ops as kops

# bytes of the two (pairs, d) fp32 gathers of a chunk of the shortlist
# that ``fused_adjacency`` decides at a time: the shortlist holds up to
# m^2 pairs, too many to gather at once; 256 MiB (1M pairs at d = 32)
# lets the complete graph's round at C = 4096 hold its peak beside the
# AMA's dual and the session's warm one (1.07 GB each)
_ADJ_BYTES = 1 << 28


class DeviceConvexResult(NamedTuple):
    """Result on the points' device (``n_iter`` and ``moved`` are host
    values: the loop reads them anyway)."""
    labels: torch.Tensor      # (m,) int32 fusion-graph root id per point
    centers: torch.Tensor     # (m, d) root-indexed cluster means of u
    u: torch.Tensor           # (m, d) final fused representatives
    n_clusters: torch.Tensor  # () int32 number of distinct roots
    n_iter: int               # AMA iterations actually run
    lam: torch.Tensor         # () float32 fusion penalty used
    nu: Optional[torch.Tensor] = None   # (E, d) final dual (fixed lambda)
    moved: Optional[float] = None       # the last iteration's dual step
    thresh: Optional[float] = None      # the stop threshold it met


def _ama_fixed_point(a, lams, edges: Edges, *, iters: int, tol: float,
                     nu0=None):
    """Batched AMA: a (m, d), lams (L,) -> (u (L, m, d), nu (L, E, d),
    n_iter, moved, thresh).

    Every solve advances together; the loop stops when the largest dual
    step (rescaled to the primal's units) is at most the scale-aware
    threshold, or after ``iters`` iterations.  ``nu0`` (L, E, d)
    warm-starts the dual."""
    m, d = a.shape
    e = edges.n_edges
    L = lams.shape[0]
    if e == 0:
        # no fusion term: u == a is the fixed point, the dual is empty
        u = a[None].expand(L, m, d).clone()
        return u, a.new_zeros((L, 0, d)), 0, None, None
    eta = torch.as_tensor(1.0 / edges.inv_eta, dtype=torch.float32,
                          device=a.device)
    if edges.weights.stride(0) == 0:
        # one weight for every edge (the complete graph): (L, 1), which
        # the prox kernel broadcasts through strides
        radius = lams[:, None] * edges.weights[:1]
    else:
        radius = lams[:, None] * edges.weights[None, :]      # (L, E)
    thresh = float(tol * (1.0 + torch.max(torch.abs(a))))
    heads = segment_plan(edges.i_idx, m)
    tails = segment_plan(edges.j_idx, m)
    # the edge ends as the fused step reads them, cast once a solve
    i32, j32 = edges.i_idx.to(torch.int32), edges.j_idx.to(torch.int32)
    # one dual, allocated once a solve and stepped in place (a second
    # buffer to step into would be 1.07 GB more at the complete graph's
    # C = 4096, beside the session's warm dual); a warm start is copied
    # in, never written
    if nu0 is None:
        nu = a.new_zeros((L, e, d))
    else:
        nu = a.new_empty((L, e, d)).copy_(
            torch.as_tensor(nu0).reshape(L, e, d))
    u = a.new_empty((L, m, d))  # the primal, gathered back into it
    step = a.new_zeros(())      # the last iteration's max |new_nu - nu|
    n_iter, moved = 0, float("inf")
    while n_iter < iters and moved > thresh:
        kops.ama_gather_back(a, nu, heads, tails, u)
        kops.group_ball_proj_batched(nu, radius, u=u, i_idx=i32, j_idx=j32,
                                     eta=eta, moved=step)
        # max dual step, rescaled by 1/eta to the primal's units
        moved = float(step / eta)
        n_iter += 1
    obs.count("convex.ama.iterations", n_iter)
    u = kops.ama_gather_back(a, nu, heads, tails, u)
    return u, nu, n_iter, moved, thresh


def fused_adjacency(u, merge_tol):
    """(m, m) bool: u_i and u_j are fused.

    The reference thresholds the fp32 expansion ||u_i||^2 + ||u_j||^2 -
    2 u_i.u_j at merge_tol^2. That expansion cannot resolve a squared
    distance below about one ulp of ||u_i||^2 + ||u_j||^2, so whether
    two (nearly) coincident points far from the origin come out fused is
    decided by rounding, and differently on the card and on the CPU.
    Here a pair is fused when its direct squared difference (no
    cancellation) is at most merge_tol^2 plus half that resolution,
    2^-24 * (||u_i||^2 + ||u_j||^2): deterministic, and the reference's
    decision wherever its rounding does not decide. The kernel's
    distances shortlist the pairs within that bound plus the kernel's
    own rounding, and the shortlist is decided ``_ADJ_BYTES`` of
    gathers at a time."""
    m, d = u.shape
    d2 = kops.pairwise_sqdist(u, u)
    sq = torch.sum(u * u, dim=1)
    tol2 = merge_tol * merge_tol
    ii, jj = torch.nonzero(
        d2 <= tol2 + (d + 5) * 2.0 ** -23 * (sq[:, None] + sq[None, :]),
        as_tuple=True)
    del d2
    adj = torch.zeros((m, m), dtype=torch.bool, device=u.device)
    chunk = max(1, _ADJ_BYTES // (2 * 4 * max(d, 1)))
    for s in range(0, ii.numel(), chunk):
        i, j = ii[s:s + chunk], jj[s:s + chunk]
        diff = u[i]
        diff -= u[j]
        near = (torch.sum(diff.mul_(diff), dim=1)
                <= tol2 + 2.0 ** -24 * (sq[i] + sq[j]))
        adj[i[near], j[near]] = True
    return adj


def _fusion_components_dense(u, merge_tol):
    """Connected components of the dense fusion graph by min-label
    propagation over the (m, m) adjacency (complete graph only)."""
    m = u.shape[0]
    adj = fused_adjacency(u, merge_tol)
    lab = torch.arange(m, dtype=torch.int32, device=u.device)
    sentinel = torch.tensor(m, dtype=torch.int32, device=u.device)
    while True:
        neigh = torch.min(torch.where(adj, lab[None, :], sentinel), dim=1)
        new = torch.minimum(lab, neigh.values)
        obs.count("convex.components.steps")
        if not bool(torch.any(new != lab)):
            return new
        lab = new


def _fusion_components_edges(u, i_idx, j_idx, merge_tol):
    """Min-label propagation along the fused edges only (O(E) a step);
    the order-free ``amin`` scatter is deterministic."""
    m = u.shape[0]
    du = u[i_idx] - u[j_idx]
    fused = torch.sum(du * du, dim=1) <= merge_tol * merge_tol   # (E,)
    lab = torch.arange(m, dtype=torch.int32, device=u.device)
    sentinel = torch.tensor(m, dtype=torch.int32, device=u.device)
    while True:
        cand = torch.where(fused, torch.minimum(lab[i_idx], lab[j_idx]),
                           sentinel)
        new = (lab.clone().scatter_reduce_(0, i_idx, cand, "amin")
               .scatter_reduce_(0, j_idx, cand, "amin"))
        obs.count("convex.components.steps")
        if not bool(torch.any(new != lab)):
            return new
        lab = new


def _default_merge_tol(u):
    """max(1e-6, 1e-3 * diameter of the fused u's), as the host solver."""
    centred = u - torch.mean(u, dim=0, keepdim=True)
    diam = torch.max(torch.sqrt(torch.sum(centred * centred, dim=1))) + 1e-12
    return torch.clamp_min(1e-3 * diam, 1e-6)


def _root_indexed_centers(u, labels):
    """(m, d) per-root means of u + (m,) member counts; zero rows for
    non-root ids.  Deterministic segment sums."""
    m = u.shape[0]
    sums = segment_sum(u, segment_plan(labels, m))
    counts = torch.bincount(labels.long(), minlength=m).to(torch.float32)
    return sums / torch.clamp_min(counts, 1.0)[:, None], counts


def _components(u, merge_tol, edge_set: Optional[Edges]):
    tol = (_default_merge_tol(u) if merge_tol is None
           else torch.as_tensor(merge_tol, dtype=torch.float32,
                                device=u.device))
    if edge_set is None:
        return _fusion_components_dense(u, tol)
    return _fusion_components_edges(u, edge_set.i_idx, edge_set.j_idx, tol)


def _extract(u, lam, n_iter, merge_tol, edge_set: Optional[Edges] = None,
             nu=None, moved=None, thresh=None) -> DeviceConvexResult:
    labels = _components(u, merge_tol, edge_set)
    centers, counts = _root_indexed_centers(u, labels)
    return DeviceConvexResult(
        labels=labels, centers=centers, u=u,
        n_clusters=torch.sum(counts > 0).to(torch.int32), n_iter=int(n_iter),
        lam=torch.as_tensor(lam, dtype=torch.float32, device=u.device),
        nu=nu, moved=moved, thresh=thresh)


def _over(x, divisor):
    """x / divisor in fp32 with a true division on every device (a Python
    divisor would be a multiply by its reciprocal on CUDA)."""
    return x / torch.tensor(divisor, dtype=torch.float32, device=x.device)


def _min_pairwise_dist(a):
    d2 = kops.pairwise_sqdist(a, a)
    d2.fill_diagonal_(float("inf"))
    return torch.sqrt(torch.min(d2))


def _nearest_dist(a, edge_set: Edges):
    """Min pairwise distance, free from the kNN builders."""
    if edge_set.min_dist is not None:
        return edge_set.min_dist
    return _min_pairwise_dist(a)


def device_convex_cluster(generator, points, *, lam=None, iters: int = 400,
                          tol: float = 1e-7, weights=None, merge_tol=None,
                          edges="complete", knn_k: int = 8,
                          warm_nu=None) -> DeviceConvexResult:
    """Fixed-lambda sum-of-norms clustering on the points' device.

    ``lam=None`` takes the upper recovery bound (17) of the
    all-singletons clustering (min pairwise distance over 2(m-1)).
    ``edges`` names a registered fusion graph (or is a builder);
    ``weights`` overrides the complete graph's per-edge weights;
    ``warm_nu`` ((E, d), a previous result's ``.nu`` on the same edge
    layout) warm-starts the dual.  ``generator`` is unused (the solver is
    deterministic); it keeps the ``device_call`` signature."""
    del generator
    a = torch.as_tensor(points).to(torch.float32)
    m = a.shape[0]
    if m < 2:
        return _extract(a, 1e-3 if lam is None else lam, 0, merge_tol)
    edge_set = get_edge_set(edges)(a, knn_k=knn_k)
    if weights is not None:
        if edges != "complete":
            raise ValueError("explicit weights= are defined in complete-"
                             "graph edge order; use edge-set options for "
                             f"edges={edges!r}")
        edge_set = edge_set._replace(weights=torch.as_tensor(weights).to(
            a.device, torch.float32))
    if lam is None:
        lam = _over(_nearest_dist(a, edge_set), 2.0 * (m - 1))
    lam = torch.as_tensor(lam, dtype=torch.float32, device=a.device)
    nu0 = None if warm_nu is None else torch.as_tensor(warm_nu)[None]
    u, nu, n_iter, moved, thresh = _ama_fixed_point(
        a, lam.reshape(1), edge_set, iters=iters, tol=tol, nu0=nu0)
    sparse = None if edges == "complete" else edge_set
    return _extract(u[0], lam, n_iter, merge_tol, sparse, nu=nu[0],
                    moved=moved, thresh=thresh)


def _linspace(lo, hi, num: int):
    """``jnp.linspace``'s fp32 arithmetic: lo * (1 - t) + hi * t over
    t = i / (num - 1), then the exact endpoint."""
    if num == 1:
        return lo.reshape(1)
    t = _over(torch.arange(num - 1, dtype=torch.float32, device=lo.device),
              num - 1)
    return torch.cat([lo * (1 - t) + hi * t, hi.reshape(1)])


def device_clusterpath(generator, points, *, n_lambdas: int = 10,
                       iters: int = 300, tol: float = 1e-7, merge_tol=None,
                       edges="complete",
                       knn_k: int = 8) -> DeviceConvexResult:
    """K-free lambda-ladder convex clustering on the points' device.

    ``n_lambdas`` equidistant penalties from the singleton recovery bound
    (17) to 2 max_i ||a_i - abar|| / m advance as one batched AMA solve;
    the clustering recovered by the most rungs wins (plurality, K' > 1
    breaking ties)."""
    del generator
    a = torch.as_tensor(points).to(torch.float32)
    m = a.shape[0]
    if m < 2:
        return _extract(a, 1e-3, 0, merge_tol)
    edge_set = get_edge_set(edges)(a, knn_k=knn_k)
    lam_lo = torch.clamp_min(_over(_nearest_dist(a, edge_set), 2.0 * (m - 1)),
                             1e-8)
    centred = a - torch.mean(a, dim=0, keepdim=True)
    lam_hi = torch.maximum(
        _over(2.0 * torch.max(torch.sqrt(torch.sum(centred * centred, dim=1))),
              m),
        lam_lo * 10.0)
    lams = _linspace(lam_lo, lam_hi, n_lambdas)
    u, _, n_iter, moved, thresh = _ama_fixed_point(a, lams, edge_set,
                                                   iters=iters, tol=tol)
    sparse = None if edges == "complete" else edge_set
    labels_l, centers_l, ncl = [], [], []
    for u_l in u:
        labels = _components(u_l, merge_tol, sparse)
        centers, counts = _root_indexed_centers(u_l, labels)
        labels_l.append(labels)
        centers_l.append(centers)
        ncl.append(torch.sum(counts > 0))
    ncl = torch.stack(ncl)
    plurality = torch.sum(ncl[None, :] == ncl[:, None], dim=1)
    sel = int(torch.argmax(plurality * 2 + (ncl > 1).long()))
    return DeviceConvexResult(
        labels=labels_l[sel], centers=centers_l[sel], u=u[sel],
        n_clusters=ncl[sel].to(torch.int32), n_iter=n_iter, lam=lams[sel],
        moved=moved, thresh=thresh)
