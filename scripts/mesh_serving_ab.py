"""The route server's ingest row over an unmeshed session and over the
same session on a one-rank client mesh (whose server sends every ingest
and round on its ordered log), in alternating turns in one process, on
one GPU.

    python3 scripts/mesh_serving_ab.py [--backend nccl|gloo] [--rounds 2]

Both sessions are ``serving.loadgen.build_session``'s fixture at
C = 1 048 576, sketch 64, k = 8 (phase 4d's).  Each turn is one
``loadgen.run_row``: 16 batched callers for 3 s, keyed waves of 256
every 0.2 s and one background warm refinalize midway; then the same row
without ingest.  The turns go flat, mesh, mesh, flat, once per round, so
that a drift of the host or the card shows as a spread inside each side.
Prints one JSON line a row (qps, route p50 / p99, refinalize under load,
the ``mesh.broadcast`` span's ms) and the card's name and power limit.
Needs a CUDA device; imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import socket
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

CLIENTS, CLUSTERS, SKETCH = 1_048_576, 8, 64


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args()

    import torch

    from repro_torch import obs
    from repro_torch.device import card_line
    from repro_torch.launch.mesh import client_mesh
    from repro_torch.serving import loadgen

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mesh = client_mesh(1, backend=args.backend, device="cuda", rank=0,
                       init_method=f"tcp://localhost:{port}")
    kw = dict(clients=CLIENTS, clusters=CLUSTERS, sketch_dim=SKETCH, seed=0,
              device="cuda")
    flat, rows = loadgen.build_session(**kw)
    meshed, _ = loadgen.build_session(mesh=mesh, **kw)
    sides = {"flat": flat, "mesh": meshed}
    for ingest in (True, False):
        for _ in range(args.rounds):
            for name in ("flat", "mesh", "mesh", "flat"):
                row = loadgen.run_row(sides[name], rows, mode="closed",
                                      batched=True, callers=16,
                                      ingest=ingest, ingest_log=[],
                                      duration_s=args.seconds, max_batch=64,
                                      max_wait_ms=0.5, queue_depth=1024)
                hist = obs.snapshot()["histograms"].get(
                    "mesh.broadcast.ms", {})
                print(json.dumps({
                    "side": name, "backend": args.backend,
                    "ingest": ingest, "qps": row["qps"],
                    "route_p50_ms": row["route_p50_ms"],
                    "route_p99_ms": row["route_p99_ms"],
                    "refinalize_under_load_ms":
                        row["refinalize_under_load_ms"],
                    "ingest_waves": row["ingest_waves"],
                    "broadcast_ms": hist.get("sum", 0.0)}), flush=True)
    print(card_line(torch.device("cuda")), flush=True)


if __name__ == "__main__":
    main()
