"""Roofline baseline sweep: the calibrated three-term roofline for every
(arch x shape) on the single-pod mesh (the port of
``repro/roofline/run_sweep.py``), against the H100's peaks.

  PYTHONPATH=src python -m repro_torch.roofline.run_sweep --arch qwen2_0_5b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.roofline.run_sweep --device cpu --json out.jsonl
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.roofline.measure import measure_combo


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--json", default="roofline_baseline.jsonl")
    ap.add_argument("--device", default=None,
                    help="the mesh's device type: cuda (default) or cpu")
    args = ap.parse_args(argv)

    mesh = make_production_mesh(multi_pod=args.multi_pod, device=args.device)
    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    failed = 0
    for arch in archs:
        for shape in shapes:
            try:
                _, info = measure_combo(arch, shape, mesh)
            except Exception as e:  # noqa: BLE001
                info = {"arch": arch, "shape": shape, "status": "FAIL",
                        "error": f"{type(e).__name__}: {e}"}
                failed += 1
            if info["status"] == "OK":
                r = info["roofline"]
                print(f"[OK  ] {arch:22s} {shape:12s} "
                      f"compute {r['compute_s']*1e3:8.2f}ms  "
                      f"memory {r['memory_s']*1e3:8.2f}ms  "
                      f"coll {r['collective_s']*1e3:8.2f}ms  "
                      f"-> {r['bottleneck']:10s} "
                      f"useful={r['useful_flop_ratio']:.2f}", flush=True)
            else:
                print(f"[{info['status']:4s}] {arch:22s} {shape:12s} "
                      f"{info.get('reason') or info.get('error')}",
                      flush=True)
            with open(args.json, "a") as f:
                f.write(json.dumps(info) + "\n")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
