"""Shared set-up of the benchmark's CPU tests: a copy of the benchmark
(``BENCHMARK.json`` and ``odcl_bench/``) in a temporary root, beside a
link to the repository's ``src``, with every configuration cut to a
size the CPU runs in a second."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
TINY = {"odcl-km-1m": 512, "odcl-cc-4k": 64}


def make_root(base: Path, clients=TINY) -> Path:
    """A runnable copy of the benchmark under ``base``: the configurations
    named in ``clients`` cut to that many clients."""
    root = base / "bench"
    root.mkdir()
    shutil.copy(REPO / "BENCHMARK.json", root)
    shutil.copytree(REPO / "odcl_bench", root / "odcl_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "src").symlink_to(REPO / "src")
    for name, c in clients.items():
        path = root / "odcl_bench" / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg["clients"] = c
        path.write_text(json.dumps(cfg))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    torch.set_num_threads(2)
    return make_root(tmp_path)
