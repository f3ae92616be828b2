"""Chip check of the PyTorch/CUDA port on one NVIDIA GPU (Hopper).

    python3 chip_smoke.py

Phases, each of which must pass (the script exits non-zero otherwise):

 1. the card's name and power limit; build every kernel of the main path
    from ``src/repro_torch/kernels/csrc`` (one nvcc per source, started
    together) and print the build seconds;
 2. each kernel against its plain PyTorch version on the card, at the
    main path's shapes ((1 048 576, 64), (4096, 64) and (1, 64) rows
    against (8, 64) centers) and at ragged ones, synchronizing after every
    launch: ``pairwise_sqdist`` within rtol 1e-5 and atol
    1e-4 * (||a||^2 + ||b||^2); ``kmeans_assign`` labels equal on every
    row whose two nearest distances differ by more than 1e-5 relative
    (the count of rows left out is printed), sums within rtol 1e-5 /
    atol 1e-4 and counts equal where the labels are, and a repeat run
    bit-identical;
 3. a small round on the card against the same round on the CPU (the
    plain versions), with the same inputs: identical partitions and route
    labels, parameters within rtol 1e-5;
 4. the main path at full size: ``simulate`` of the ODCL-KM one-shot
    round over 1 048 576 ridge clients (dim 16, 64 samples each, JL
    sketch 64, k = 8, kmeans++ + Lloyd, cluster mean), 10 warm finalizes
    after the first, and 4096 never-seen clients routed one request at a
    time and as one batch, with every kernel's launch count set to 0 just
    before and read just after; purity and route purity must be 1.0, the
    one-by-one routes must give the batch's labels, and every kernel must
    have launched;
 5. one JSON line ``{"kernels": [...]}``: per kernel its launches in
    phase 4, its largest error against the plain version, its time, the
    plain version's and one PyTorch call's (where one computes the same
    function) at the main path's shape, and the least time the card could
    take (bytes at 3.35 TB/s or fp32 operations at 67 TFLOP/s);
 6. the card's name and power limit again, then the last line
    ``{"ok": true, "device": {...}}``.

``--profile`` adds, after phase 4, a second run of the main path under
``torch.profiler``: device time by kernel and the device's busy share.

The port imports no JAX; neither does this script.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA's data sheet
FP32_FLOP_PER_S = 67e12            # fp32 outside the tensor cores
MAIN_M, MAIN_K, MAIN_D = 1_048_576, 8, 64
ROUTE_M = 4096
FINALIZES = 11                     # the first, then 10 warm repeats


def fail(msg: str):
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls,
    after two warm-up calls, by CUDA events."""
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def draw(seed: int, *shapes):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(s, generator=gen, device="cuda") for s in shapes]


# ------------------------------------------------------------ phase 2

def compare_pairwise(pairwise_l2, a, b) -> float:
    got = pairwise_l2.pairwise_sqdist(a, b)
    torch.cuda.synchronize()
    want = pairwise_l2.pairwise_sqdist_ref(a, b)
    scale = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :]
    excess = (got - want).abs() - (1e-5 * want.abs() + 1e-4 * scale)
    check(float(excess.max()) <= 0.0,
          f"pairwise_sqdist disagrees at {tuple(a.shape)} x "
          f"{tuple(b.shape)}: excess {float(excess.max())}")
    again = pairwise_l2.pairwise_sqdist(a, b)
    torch.cuda.synchronize()
    check(torch.equal(again, got), "pairwise_sqdist is not repeatable")
    return float((got - want).abs().max())


def compare_assign(kmeans_assign, pairwise_l2, pts, cts) -> tuple:
    m, k = pts.shape[0], cts.shape[0]
    lab, sums, cnt = kmeans_assign.kmeans_assign(pts, cts)
    torch.cuda.synchronize()
    wl, ws, wc = kmeans_assign.kmeans_assign_ref(pts, cts)
    if k > 1:
        two = torch.topk(pairwise_l2.pairwise_sqdist_ref(pts, cts), 2, dim=1,
                         largest=False).values
        clear = (two[:, 1] - two[:, 0]) > 1e-5 * two[:, 1].abs()
    else:
        clear = torch.ones(m, dtype=torch.bool, device=pts.device)
    excluded = int(m - int(clear.sum()))
    check(torch.equal(lab[clear], wl[clear]),
          f"kmeans_assign labels disagree at {tuple(pts.shape)} x "
          f"{tuple(cts.shape)}")
    if excluded:
        # counts and sums of the rows whose label is clear-cut
        ws = torch.nn.functional.one_hot(lab.long(), k).float().T @ pts
        wc = torch.bincount(lab.long(), minlength=k).float()
    check(torch.equal(cnt, wc), f"kmeans_assign counts disagree at "
          f"{tuple(pts.shape)} x {tuple(cts.shape)}")
    err = (sums - ws).abs()
    check(bool((err <= 1e-4 + 1e-5 * ws.abs()).all()),
          f"kmeans_assign sums disagree at {tuple(pts.shape)} x "
          f"{tuple(cts.shape)}: max err {float(err.max())}")
    again = kmeans_assign.kmeans_assign(pts, cts)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(again, (lab, sums, cnt))),
          "kmeans_assign is not bit-identical from run to run")
    return float(err.max()), excluded


def phase_kernels(pairwise_l2, kmeans_assign) -> dict:
    # the main path's three shapes (Lloyd over all rows, a batch of
    # routes, one route), then ragged m in {1, 7, 4097}, k in {1, 8, 257},
    # d in {16, 64, 200}
    shapes = [(MAIN_M, MAIN_K, MAIN_D), (ROUTE_M, MAIN_K, MAIN_D),
              (1, MAIN_K, MAIN_D), (1, 1, 16), (7, 257, 200), (4097, 8, 200), (4097, 1, 64),
              (7, 8, 16), (1, 257, 64), (4097, 257, 16), (4097, 257, 200)]
    errs = {}
    for i, (m, k, d) in enumerate(shapes):
        a, b = draw(100 + i, (m, d), (k, d))
        # points near the centers, as in Lloyd: clusters of (k, d) blobs
        pts = b[torch.arange(m, device="cuda") % k] + 0.5 * a
        pe = compare_pairwise(pairwise_l2, a, b)
        ae, excluded = compare_assign(kmeans_assign, pairwise_l2, pts, b)
        print(f"[chip_smoke] kernels at ({m},{d})x({k},{d}): pairwise max "
              f"abs err {pe:.3g}, assign sums max abs err {ae:.3g}, "
              f"{excluded} near-tie rows left out of the label check",
              flush=True)
        if (m, k, d) == (MAIN_M, MAIN_K, MAIN_D):
            errs = {"pairwise_sqdist": pe, "kmeans_assign": ae}
    return errs


# ------------------------------------------------------------ phase 3

def phase_small_round() -> None:
    from repro_torch.core.engine.session import AggregationSession

    rng = np.random.default_rng(1)
    optima = rng.normal(size=(4, 16)) * 4.0
    truth = np.arange(512) % 4
    thetas = (optima[truth] + 0.5 * rng.normal(size=(512, 16))).astype(
        np.float32)
    probes = (optima[truth[:64]] + 0.5 * rng.normal(size=(64, 16))).astype(
        np.float32)
    proj = rng.normal(size=(16, 32)).astype(np.float32) / np.sqrt(32.0)
    init = thetas[:4] @ proj                 # one client of each cluster
    out = {}
    for dev in ("cpu", "cuda"):
        sess = AggregationSession(512, sketch_dim=32,
                                  projection=torch.from_numpy(proj),
                                  device=dev)
        for lo, hi in [(0, 200), (200, 333), (333, 512)]:
            sess.ingest({"theta": torch.from_numpy(thetas[lo:hi])})
        state, labels, info = sess.finalize(
            k=4, algo_options={"init": "warm",
                               "init_centers": torch.from_numpy(init)})
        routed = sess.route(sess.sketch_params(
            {"theta": torch.from_numpy(probes)}))
        out[dev] = (labels, state.params["theta"].cpu().numpy(), routed,
                    info["meta"]["n_iter"])
    (cl, cp, cr, cn), (gl, gp, gr, gn) = out["cpu"], out["cuda"]
    check(np.array_equal(cl, gl), "small round: partitions differ")
    check(np.array_equal(cr, gr), "small round: route labels differ")
    check(cn == gn, "small round: Lloyd iteration counts differ")
    check(np.allclose(gp, cp, rtol=1e-5, atol=1e-5) and np.isfinite(gp).all(),
          "small round: averaged parameters differ")
    print(f"[chip_smoke] small round: card == CPU (partition, {len(gr)} "
          f"route labels, n_iter {gn})", flush=True)


# --------------------------------------------------- --profile only

def phase_profile(simulate) -> dict:
    """A second, traced run of the main path (fewer routes): device time
    by kernel and the device's busy share of the traced wall clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        simulate(clients=MAIN_M, clusters=8, dim=16, samples=64,
                 sketch_dim=64, wave=65_536, algorithm="kmeans-device",
                 init="kmeans++", route_probes=256, finalize_repeats=3,
                 device="cuda")
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:15]
    return {"traced_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "top_kernels": [{"name": e.key[:90], "calls": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top]}


# ------------------------------------------------------------ phase 5

def kernel_rows(pairwise_l2, kmeans_assign, launches, errs) -> list:
    m, k, d = MAIN_M, MAIN_K, MAIN_D
    a, b = draw(7, (m, d), (k, d))
    pts = b[torch.arange(m, device="cuda") % k] + 0.5 * a
    f4 = 4.0
    rows = []
    p_bytes = f4 * (m * d + k * d + m * k)
    p_ops = 2.0 * m * k * d + 2.0 * (m + k) * d + 3.0 * m * k
    a_bytes = f4 * (m * d + k * d) + 4.0 * m + f4 * (k * d + k)
    a_ops = 2.0 * m * k * d + 2.0 * m * d + 3.0 * m * k + m * d
    specs = [
        ("pairwise_sqdist", "src/repro_torch/kernels/csrc/pairwise_l2.cu",
         "src/repro/kernels/pairwise_l2.py:44",
         lambda: pairwise_l2.pairwise_sqdist(a, b),
         lambda: pairwise_l2.pairwise_sqdist_ref(a, b),
         lambda: torch.cdist(a, b), p_bytes, p_ops),
        ("kmeans_assign", "src/repro_torch/kernels/csrc/kmeans_assign.cu",
         "src/repro/kernels/kmeans_assign.py:48",
         lambda: kmeans_assign.kmeans_assign(pts, b),
         lambda: kmeans_assign.kmeans_assign_ref(pts, b), None,
         a_bytes, a_ops),
    ]
    for name, src, replaces, kern, plain, lib, nbytes, nops in specs:
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / FP32_FLOP_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": cuda_time_ms(kern), "plain_ms": cuda_time_ms(plain),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": cuda_time_ms(lib) if lib is not None else None,
            "shape": f"({m},{d})x({k},{d})",
        })
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description="chip check of the port")
    ap.add_argument("--profile", action="store_true",
                    help="also trace a second main-path run with "
                         "torch.profiler and print device time by kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("[chip_smoke] FAIL: no CUDA device (torch.cuda.is_available() "
              "is False)", flush=True)
        sys.exit(2)
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import kmeans_assign, ops, pairwise_l2
    from repro_torch.launch.simulate import simulate

    card = card_line()
    print(f"[chip_smoke] {card}", flush=True)
    t0 = time.perf_counter()
    built = _build.build()
    print(f"[chip_smoke] kernels built in {time.perf_counter() - t0:.1f}s "
          f"({json.dumps(built)})", flush=True)

    errs = phase_kernels(pairwise_l2, kmeans_assign)
    phase_small_round()

    ops.reset_launch_counts()
    summary = simulate(clients=MAIN_M, clusters=8, dim=16, samples=64,
                       sketch_dim=64, wave=65_536, algorithm="kmeans-device",
                       init="kmeans++", route_probes=ROUTE_M,
                       finalize_repeats=FINALIZES, device="cuda")
    launches = ops.launch_counts()
    sv = summary["serving"]
    check(summary["purity"] == 1.0, f"purity {summary['purity']} != 1.0")
    check(sv["route_purity"] == 1.0,
          f"route purity {sv['route_purity']} != 1.0")
    check(sv["route_single_purity"] == 1.0,
          f"single-route purity {sv['route_single_purity']} != 1.0")
    check(sv["route_single_vs_batch"] == 1.0,
          "routes one by one disagree with the batch on "
          f"{1.0 - sv['route_single_vs_batch']:.3g} of the clients")
    check(summary["n_clusters_recovered"] == 8, "did not recover 8 clusters")
    check(np.isfinite(summary["mse"]) and summary["mse"] < 1e-2,
          f"served models off their optima: mse {summary['mse']}")
    for name, n in launches.items():
        check(n > 0, f"the main path launched no {name} kernel")
    print(json.dumps({"main_path": {
        "clients": summary["clients"], "clusters": summary["clusters"],
        "sketch_dim": summary["sketch_dim"], "purity": summary["purity"],
        "route_purity": sv["route_purity"],
        "route_single_purity": sv["route_single_purity"],
        "route_single_vs_batch": sv["route_single_vs_batch"],
        "mse": summary["mse"],
        "n_iter": summary["meta"]["n_iter"], "phases": summary["phases"],
        "finalize_first_ms": sv["finalize_first_ms"],
        "finalize_warm_count": sv["finalize_warm_count"],
        "finalize_p50_ms": sv["finalize_p50_ms"],
        "finalize_p99_ms": sv["finalize_p99_ms"],
        "route_p50_ms": sv["route_p50_ms"], "route_p99_ms": sv["route_p99_ms"],
        "routes_per_s": sv["routes_per_s"],
        "route_batch_ms": sv["route_batch_ms"],
        "batched_routes_per_s": sv["batched_routes_per_s"],
        "spans_p50_ms": {
            name[:-3]: h["p50"]
            for name, h in summary["obs"]["histograms"].items()
            if h.get("count")},
        "launches": launches, "device": summary["device_name"],
        "card": card}}), flush=True)

    if args.profile:
        print(json.dumps({"profile": phase_profile(simulate)}), flush=True)
    print(json.dumps({"kernels": kernel_rows(pairwise_l2, kmeans_assign,
                                             launches, errs)}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
