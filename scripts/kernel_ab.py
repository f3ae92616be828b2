"""Device time of two checkouts' kmeans_assign and pairwise_sqdist kernels
at the main paths' shapes, in turns, on one GPU.

    python3 scripts/kernel_ab.py --parent DIR

DIR is another checkout of the repo (for example the parent commit,
unpacked with ``git archive <commit> | tar -x -C DIR``).  The script runs
its measurement in a fresh process for each tree, in the order parent,
this tree, this tree, parent, so that a drift of the card's clocks shows
as a difference between the two runs of one tree.  Each process builds
that tree's kernels and times one call at each shape as ``chip_smoke.py``
phase 5 does: the durations of the device work that 20 calls launched
(torch.profiler), over 20.  Prints one JSON line per run and the card's
name and power limit.  Needs a CUDA device; imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (kernel, m, k, d): the Lloyd / kmeans++ shape, the batch route, the
# single routes of the KM and convex paths, one kNN tile
SHAPES = [("kmeans_assign", 1_048_576, 8, 64), ("kmeans_assign", 4096, 8, 64),
          ("kmeans_assign", 1, 8, 64), ("kmeans_assign", 1, 8, 32),
          ("pairwise_sqdist", 1_048_576, 8, 64),
          ("pairwise_sqdist", 1024, 16_384, 32)]
REPS = 20


def device_ms(fn) -> float:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / REPS


def measure() -> dict:
    """Time the kernels of the ``repro_torch`` first on sys.path."""
    import torch
    from repro_torch.kernels import kmeans_assign, pairwise_l2

    out = {}
    for i, (name, m, k, d) in enumerate(SHAPES):
        gen = torch.Generator(device="cuda").manual_seed(i)
        a = torch.randn((m, d), generator=gen, device="cuda")
        b = torch.randn((k, d), generator=gen, device="cuda")
        if name == "kmeans_assign":
            pts = b[torch.arange(m, device="cuda") % k] + 0.5 * a
            ms = device_ms(lambda: kmeans_assign.kmeans_assign(pts, b))
        else:
            ms = device_ms(lambda: pairwise_l2.pairwise_sqdist(a, b))
        out[f"{name} ({m},{d})x({k},{d})"] = ms
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path,
                    help="the other checkout to time beside this one")
    ap.add_argument("--measure", action="store_true",
                    help="(internal) time the repro_torch on sys.path")
    args = ap.parse_args()
    if args.measure:
        print(json.dumps(measure()), flush=True)
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_ab: no CUDA device")
    if args.parent is None:
        ap.error("--parent DIR is required")
    trees = {"parent": args.parent.resolve(), "change": ROOT}
    for label in ("parent", "change", "change", "parent"):
        env = dict(os.environ, PYTHONPATH=str(trees[label] / "src"))
        run = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--measure"], env=env, capture_output=True,
                             text=True, check=False, timeout=600)
        if run.returncode != 0:
            sys.exit(f"kernel_ab: the {label} run failed:\n{run.stderr[-3000:]}")
        times = json.loads(run.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": label, "device_ms": times}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
