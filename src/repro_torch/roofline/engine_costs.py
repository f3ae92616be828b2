"""Achieved-vs-peak numbers for the aggregation engine (the port of
``repro/roofline/engine_costs.py``).

  * :func:`program_rows_from_snapshot` reads the ``"<label>.flops"`` /
    ``"<label>.bytes"`` gauges and ``"<label>.execute.ms"`` histograms
    that ``core/engine/aggregate._Program`` records into ``obs``, and
    turns every program the run executed into an achieved-vs-peak row.
    The reference's gauges are XLA's cost analysis of each compiled
    program; the port's are counted from shapes (``kernel_costs``) over
    the kernel calls a program made and its own stated term.
  * :func:`kernel_probe` / :func:`engine_kernel_report` time the
    per-iteration kernels alone at a bench row's sizes, for its
    ``kernels`` section: warm calls timed by CUDA events on the card (the
    host clock on the CPU), the cost from ``kernel_costs``.

Peaks come from :class:`~repro_torch.roofline.analysis.Hardware`.  On an
H100 the engine kernels compute in fp32 on the CUDA cores, so
``HW_H100_FP32`` applies; on the CPU ``HW_CPU`` is a nominal reference
chip (round laptop-class peaks) that keeps fraction-of-peak columns
comparable between CPU runs: no claim about the host, and every report's
``hw["name"]`` says which was used.
"""
from __future__ import annotations

import time

import torch

from repro_torch.device import card_line, resolve_device
from repro_torch.roofline import kernel_costs
from repro_torch.roofline.analysis import HW_H100_FP32, Hardware

# nominal reference peaks for CPU runs: 100 GFLOP/s fp32, 25 GB/s
# memory, 10 GB/s interconnect; round on purpose, for stable ratios
HW_CPU = Hardware(name="cpu-nominal", peak_flops=1e11, hbm_bw=2.5e10,
                  link_bw=1e10)


def detect_hardware(device=None) -> Hardware:
    """The reference peaks of ``device`` (default: the current CUDA
    device, as the port's entry points resolve it): ``HW_H100_FP32`` on
    an H100, ``HW_CPU`` on the CPU.  Any other card raises: its peaks
    are not known here."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return HW_CPU
    name = torch.cuda.get_device_name(dev)
    if "H100" not in name:
        raise ValueError(f"no peaks known for {name!r}; pass hw=")
    return HW_H100_FP32


def achieved_vs_peak(cost: dict, seconds: float, hw: Hardware) -> dict:
    """One program's roofline row: a cost dict (``"flops"``, ``"bytes
    accessed"``) and measured seconds -> achieved rates and fractions of
    the peaks."""
    flops = float(cost.get("flops", 0.0))
    nbytes = float(cost.get("bytes accessed", 0.0))
    s = max(float(seconds), 1e-12)
    return {
        "flops": flops,
        "bytes": nbytes,
        "exec_s": float(seconds),
        "achieved_flops_per_s": flops / s,
        "achieved_bytes_per_s": nbytes / s,
        "flops_frac_of_peak": flops / s / hw.peak_flops,
        "bytes_frac_of_peak": nbytes / s / hw.hbm_bw,
    }


def _cost_dict(cost: tuple) -> dict:
    nbytes, ops = cost
    return {"flops": float(ops), "bytes accessed": float(nbytes)}


def kernel_probe(name: str, fn, args, hw: Hardware, cost: tuple,
                 iters: int = 3) -> dict:
    """Time ``iters`` warm calls of ``fn(*args)`` (after one warm-up)
    and return the achieved-vs-peak row of ``cost`` = ``(bytes, ops)``
    of one call, tagged with the argument shapes.  On the card the
    window is CUDA events around the calls; on the CPU the host clock."""
    fn(*args)                                          # warm-up
    cuda = args[0].is_cuda
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        per_iter = start.elapsed_time(end) / 1e3 / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        per_iter = (time.perf_counter() - t0) / iters
    row = achieved_vs_peak(_cost_dict(cost), per_iter, hw)
    row["name"] = name
    row["shapes"] = [list(a.shape) for a in args]
    return row


def engine_kernel_report(clients: int, sketch_dim: int, k: int,
                         algorithm: str, *, edges: str = "complete",
                         knn_k: int = 8, max_edges: int = 1 << 21,
                         hw: Hardware | None = None, device=None) -> list:
    """Probe the per-iteration kernel a bench row's algorithm drives.

    Lloyd-family rows probe ``kmeans_assign`` at the row's (C, s) x
    (k, s); convex rows probe ``group_ball_proj_batched`` at the fusion
    graph's edge count (C knn_k for knn, C(C - 1)/2 complete), capped at
    ``max_edges`` with an ``edges_capped`` flag so that large-C rows do
    not allocate an O(C^2) probe tensor."""
    from repro_torch.kernels import ops as kops

    dev = resolve_device(device)
    hw = hw or detect_hardware(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    if algorithm.startswith("kmeans"):
        pts = torch.randn((clients, sketch_dim), generator=gen, device=dev)
        ctr = pts[:max(k, 1)].contiguous()
        return [kernel_probe(
            "kmeans_assign", kops.kmeans_assign, (pts, ctr), hw,
            kernel_costs.kmeans_assign(clients, ctr.shape[0], sketch_dim))]
    n_edges = (clients * knn_k if edges == "knn"
               else clients * (clients - 1) // 2)
    e = min(n_edges, max_edges)
    v = torch.randn((1, e, sketch_dim), generator=gen, device=dev)
    radius = torch.ones((1, e), device=dev)
    row = kernel_probe(
        "group_ball_proj_batched", kops.group_ball_proj_batched, (v, radius),
        hw, kernel_costs.group_ball_proj(e, sketch_dim, e))
    row["edges"] = int(e)
    row["edges_capped"] = bool(n_edges > max_edges)
    return [row]


def program_rows_from_snapshot(snapshot: dict,
                               hw: Hardware | None = None) -> dict:
    """Achieved-vs-peak per program, from an ``obs.snapshot()``: each
    ``"<label>.flops"`` gauge (the program's last call) with the p50 of
    its ``"<label>.execute.ms"`` histogram."""
    hw = hw or detect_hardware()
    gauges = snapshot.get("gauges", {})
    hists = snapshot.get("histograms", {})
    out = {}
    for name, flops in gauges.items():
        if not name.endswith(".flops"):
            continue
        label = name[:-len(".flops")]
        h = hists.get(f"{label}.execute.ms")
        if not h or not h.get("count"):
            continue
        cost = {"flops": flops,
                "bytes accessed": gauges.get(f"{label}.bytes", 0.0)}
        row = achieved_vs_peak(cost, h["p50"] / 1000.0, hw)
        row["exec_count"] = h["count"]
        out[label] = row
    return out


def hardware_info(hw: Hardware | None = None, device=None) -> dict:
    """The peaks in use and the device: on a card also its name and power
    limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them."""
    dev = resolve_device(device)
    hw = hw or detect_hardware(dev)
    return {"name": hw.name, "peak_flops": hw.peak_flops,
            "hbm_bw": hw.hbm_bw, "link_bw": hw.link_bw,
            "backend": dev.type, "card": card_line(dev)}
