"""The readings the limits of ``correct`` are set from (not run by the
benchmark's own runs).

For each seed, one process builds the cell as a run does, runs the
window for ``--seconds`` and judges the program's served round (the
lower reading); then it puts the control in the program's place, the
plain reference computed in TF32, the precision below the
configurations' fp32 (``judge.control_outputs``), and judges its outputs
by the same numbers (the upper reading).  ``--init random`` runs the
program with its uniform seeding in place of kmeans++ (the fault the
seeding's quality is held against) and reads the program alone.

    python3 odcl_bench/control.py --workload km-1m-round --seconds 3 \\
        --seeds 101 102 103 [--init random] [--out chiprun_out/c.jsonl]

One JSON line a seed: ``{"seed", "program": {...}, "control": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from odcl_bench import harness, inputs, judge  # noqa: E402


def readings(workload: str, seed: int, seconds: float,
             root: Path = harness.ROOT, init: str | None = None) -> dict:
    """The program's numbers after a short window, and the control's
    (not read with ``init``, the program's seeding put in place of
    kmeans++)."""
    bench = harness.load_bench(root)
    _, cfg, mix = harness.resolve(bench, workload, root)
    if init is not None:
        cfg = dict(cfg, algo_options=dict(cfg["algo_options"], init=init))
    session_cls, _, _ = harness.import_program(root)
    loop = harness.Loop(session_cls, cfg, mix, seed, "cuda")
    harness.set_up(loop)
    first = loop.g + 1
    harness.Window(loop).run(seconds, time.perf_counter())
    g = loop.g
    program, _ = harness.judge_loop(loop, cfg, list(range(first, g + 1)))
    line = {"workload": workload, "seed": seed, "init": init,
            "rounds": g + 1 - first, "program": program}
    if init is None:
        ctl = judge.control_outputs(cfg, loop.up, g, loop.lam,
                                    inputs.generator(seed, 7, "cuda"))
        line["control"], _ = judge.compare(cfg, ctl, loop.up, loop.lam)
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--init")
    p.add_argument("--out")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        line = json.dumps(readings(args.workload, seed, args.seconds,
                                   init=args.init))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
