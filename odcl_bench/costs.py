"""The yardstick's arithmetic: the H100's published peaks, the work of
one call of each hand-written kernel from its shapes (a frozen copy of
``repro_torch/roofline/kernel_costs.py``'s functions, held equal to them
by ``odcl_bench/tests``), and the work a round of a cell requires,
whatever implements it.

Bytes count each input read once and each output written once (fp32);
ops count the arithmetic the function needs.  A least time is the larger
of bytes at the HBM rate and ops at the fp32 rate: every engine kernel
and every product of these rounds is fp32 on the CUDA cores.
"""
from __future__ import annotations

import math

F32 = 4
# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def least_s(cost: tuple) -> float:
    """The least time of ``(bytes, ops)`` on the card."""
    nbytes, ops = cost
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def pairwise_sqdist(m: int, k: int, d: int, batches: int = 1) -> tuple:
    """(m, d) x (k, d) -> (m, k) squared distances by the expansion:
    2mkd for the products, 2(m + k)d for the norms, 3mk to combine and
    clamp; ``batches`` windows of that shape."""
    nbytes = F32 * (m * d + k * d + m * k)
    ops = 2.0 * m * k * d + 2.0 * (m + k) * d + 3.0 * m * k
    return batches * nbytes, batches * ops


def kmeans_assign(m: int, k: int, d: int) -> tuple:
    """(m, d) points x (k, d) centers -> labels (m,) int32, sums (k, d)
    and counts (k,): the distances as ``pairwise_sqdist`` computes them
    without the (m, k) matrix, plus md adds for the sums."""
    nbytes = F32 * (m * d + k * d) + F32 * m + F32 * (k * d + k)
    ops = 2.0 * m * k * d + 2.0 * m * d + 3.0 * m * k + m * d
    return nbytes, ops


def group_ball_proj(rows: int, d: int, radius_elems: int) -> tuple:
    """Each of ``rows`` rows of width d (over every rung) projected onto
    its ball: the rows read and written, ``radius_elems`` fp32 radii
    read; 3d + 3 ops a row (the squared norm, the scale, the compare)."""
    return (2.0 * F32 * rows * d + F32 * radius_elems,
            (3.0 * d + 3) * rows)


def radius_elems(radius) -> int:
    """Radii a prox call reads: one for a Python number, else the
    tensor's elements that are stored (a broadcast, stride-0 axis reads
    one)."""
    if not hasattr(radius, "stride"):
        return 1
    return math.prod(n for n, st in zip(radius.shape, radius.stride())
                     if st != 0)


# ----------------------------------------------------- a round's work

# Lloyd's least passes over the sketches: one that assigns, one that
# finds the assignment fixed
LLOYD_PASSES = 2


def add(*costs: tuple) -> tuple:
    return (sum(c[0] for c in costs), sum(c[1] for c in costs))


def sketch_work(w: int, d: int, s: int) -> tuple:
    """A wave's JL sketch: (w, d) @ (d, s), inputs read, rows written."""
    return F32 * (w * d + d * s + w * s), 2.0 * w * d * s


def seeding_work(c: int, k: int, s: int) -> tuple:
    """kmeans++: k - 1 passes over the (c, s) sketches, each measuring
    every row against the newest center (3 ops a value) and reading the
    (c,) distances so far."""
    return ((k - 1) * F32 * (c * s + 2 * c), (k - 1) * (3.0 * c * s + c))


def ama_work(c: int, s: int, iters: int) -> tuple:
    """``iters`` AMA iterations on the complete graph, E = c(c-1)/2
    edges: the (E, s) dual read and written once an iteration; a dual
    row's update (the edge difference, the step, the norm, the scale)
    and its two segment sums are 8s ops."""
    e = c * (c - 1) // 2
    return iters * 2.0 * F32 * e * s, iters * 8.0 * e * s


def components_work(c: int, s: int) -> tuple:
    """The fusion components of c fused points: each pair's distance once
    (3s ops), the points read."""
    return F32 * c * s, 3.0 * s * c * (c - 1) / 2


def mean_work(c: int, d: int) -> tuple:
    """Steps 3-4: each client's (d,) model read once and added into its
    cluster's sum, the labels read, each client's new row written."""
    return F32 * (2 * c * d + c), float(c * d)


def round_work(cfg: dict, mix: dict, count: int, *, warm: bool,
               ama_iters: int = 0) -> tuple:
    """The work one round of a cell requires for these inputs: its waves'
    sketches, the route of its probes, and where it serves ``count``
    live clients the clustering (kmeans++ seeding in a cold round, then
    Lloyd's least passes; or ``ama_iters`` AMA iterations and the
    components) and the per-cluster mean."""
    d, s, k = cfg["dim"], cfg["sketch_dim"], cfg["clusters"]
    w = mix["mutation_rounds"] * (round(cfg["clients"] * mix["reupload_share"])
                                  + mix["churn"])
    probes = mix.get("probes", 0)
    parts = [sketch_work(w, d, s)]
    if probes:
        parts += [sketch_work(probes, d, s), kmeans_assign(probes, k, s)]
    if count:
        parts.append(mean_work(count, d))
        if cfg["reference"] == "kmeans":
            if not warm:
                parts.append(seeding_work(count, k, s))
            parts += [kmeans_assign(count, k, s)] * LLOYD_PASSES
        else:
            parts += [ama_work(count, s, ama_iters),
                      components_work(count, s)]
    return add(*parts)
