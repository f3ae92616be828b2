"""Finalize p50 of two checkouts' ODCL-KM main path, in alternating turns,
on one GPU.

    python3 scripts/session_ab.py --parent DIR [--rounds 3]

DIR is another checkout of the repo (for example the parent commit,
unpacked with ``git archive <commit> | tar -x -C DIR``).  Each turn is a
fresh process that runs the main path of ``chip_smoke.py`` phase 4
(``launch.simulate`` at C = 1 048 576, k = 8, sketch 64, kmeans++) with
41 finalizes and prints the p50 and p99 of the 40 warm ones (all but the
first).  The turns go parent, change, change, parent, once per
round, so that a drift of the card's clocks shows as a spread inside
each side.  Ends with each side's p50s, their median and their range,
and the card's name and power limit.  Needs a CUDA device; imports no
JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REPEATS = 41


def measure() -> dict:
    """Run the main path with the ``repro_torch`` first on sys.path."""
    from repro_torch.launch.simulate import simulate

    summary = simulate(clients=1_048_576, clusters=8, dim=16, samples=64,
                       sketch_dim=64, wave=65_536, algorithm="kmeans-device",
                       init="kmeans++", finalize_repeats=REPEATS,
                       device="cuda")
    serving = summary["serving"]
    return {"finalize_p50_ms": serving["finalize_p50_ms"],
            "finalize_p99_ms": serving["finalize_p99_ms"],
            "finalize_warm_count": serving["finalize_warm_count"],
            "purity": summary["purity"]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path,
                    help="the other checkout to time beside this one")
    ap.add_argument("--rounds", type=int, default=3,
                    help="rounds of parent, change, change, parent")
    ap.add_argument("--measure", action="store_true",
                    help="(internal) time the repro_torch on sys.path")
    args = ap.parse_args()
    if args.measure:
        print(json.dumps(measure()), flush=True)
        return
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("session_ab: no CUDA device")
    if args.parent is None:
        ap.error("--parent DIR is required")
    trees = {"parent": args.parent.resolve(), "change": ROOT}
    p50s = {"parent": [], "change": []}
    for _ in range(args.rounds):
        for label in ("parent", "change", "change", "parent"):
            env = dict(os.environ, PYTHONPATH=str(trees[label] / "src"))
            run = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--measure"],
                env=env, capture_output=True, text=True, check=False,
                timeout=600)
            if run.returncode != 0:
                sys.exit(f"session_ab: the {label} run failed:\n"
                         f"{run.stderr[-3000:]}")
            out = json.loads(run.stdout.strip().splitlines()[-1])
            p50s[label].append(out["finalize_p50_ms"])
            print(json.dumps({"tree": label, **out}), flush=True)
    print(json.dumps({label: {"p50s": v, "median": float(np.median(v)),
                              "min": min(v), "max": max(v)}
                      for label, v in p50s.items()}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
