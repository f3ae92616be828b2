"""Where the streaming kmeans_assign kernel's time goes, by ablation, on the GPU.

    python3 scripts/assign_ablation.py

Builds ``src/repro_torch/kernels/csrc/kmeans_assign.cu`` as it is and with
one part of ``assign_stream_kernel`` taken out at a time, and times each
build at the Lloyd shape, points (1 048 576, 64) x centers (8, 64):

* ``kernel``: the kernel as it is;
* ``no_sums``: the summing warps skip the label sums (item_sums);
* ``no_distances``: the distance warps label row r with r mod k in place
  of its nearest center;
* ``loads_only``: neither (the TMA ring, the masks, the counts, the
  labels' stores and the reduction of the partials).

The ablated builds compute wrong sums or labels; only their times mean
anything.  Each time is the device time of one call (torch.profiler over
20 calls, as ``chip_smoke.py`` phase 5), three times a build.  Each build
goes to ``kernels/build/ablation/<name>/`` (git-ignored).  Prints one JSON
line per build and the card's name and power limit.  Needs a CUDA device;
imports no JAX.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import kmeans_assign as assign  # noqa: E402

SUMS = ("        item_sums(rows, masks, ngr, nrows - 1, k, c, q < nq ? q : 0, "
        "lane, total);\n")
NO_SUMS = "        for (int u = 0; u < 4; ++u) total[u] = 0.0;\n"
DIST = ("        label = nearest<true>(SwizzledRow{ring + s * tile_bytes, ct, "
        "box_bytes}, cen, c2, k, d);\n")
NO_DIST = "        label = ct % k;\n"
ABLATIONS = {
    "kernel": [],
    "no_sums": [(SUMS, NO_SUMS)],
    "no_distances": [(DIST, NO_DIST)],
    "loads_only": [(SUMS, NO_SUMS), (DIST, NO_DIST)],
}


def device_ms(fn, reps: int = 20) -> float:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / reps


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("assign_ablation: no CUDA device")
    csrc = _build.CSRC
    source = (csrc / "kmeans_assign.cu").read_text()
    gen = torch.Generator(device="cuda").manual_seed(0)
    centers = torch.randn((8, 64), generator=gen, device="cuda")
    points = (centers[torch.arange(1_048_576, device="cuda") % 8]
              + 0.5 * torch.randn((1_048_576, 64), generator=gen,
                                  device="cuda"))
    for name, edits in ABLATIONS.items():
        text = source
        for old, new in edits:
            if old not in text:
                sys.exit(f"assign_ablation: {name}: the source no longer "
                         f"holds {old!r}")
            text = text.replace(old, new)
        where = _build.BUILD_DIR / "ablation" / name
        where.mkdir(parents=True, exist_ok=True)
        (where / "kmeans_assign.cu").write_text(text)
        for header in csrc.glob("*.cuh"):
            shutil.copy(header, where / header.name)
        _build.CSRC = where
        _build.load.cache_clear()
        ms = [device_ms(lambda: assign.kmeans_assign(points, centers))
              for _ in range(3)]
        print(json.dumps({"ablation": name, "device_ms": ms}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
