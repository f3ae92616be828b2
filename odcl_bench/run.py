"""The benchmark's command: one run of one cell of ``BENCHMARK.json``.

    python3 odcl_bench/run.py --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

Prints the result as the last line of standard output (one JSON object)
and each number compared beside its limit as the last lines of standard
error.  Exits non-zero, and prints no result, without a CUDA device (or
with fewer than the cell asks for), without the program in the
checkout, or when a module of JAX or of the reference package is loaded
once the window has closed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

# a few host threads: the load comes from this one process
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "4")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from odcl_bench import harness  # noqa: E402


def main(argv=None) -> int:
    t_start = harness.process_start()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    bench = harness.load_bench()
    cell, _, _ = harness.resolve(bench, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), t_start=t_start)
    banned = harness.banned_modules()
    if banned:
        print(f"loaded modules of {', '.join(banned)}: the run may load "
              "neither JAX nor the reference package", file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
