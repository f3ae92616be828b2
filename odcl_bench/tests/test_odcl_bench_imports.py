"""The import guard: what the benchmark runs loads no module whose
top-level name is ``jax``, ``jaxlib``, ``flax`` or ``repro`` (compared
whole: the port, ``repro_torch``, begins with ``repro``), and the plain
reference loads nothing of the port either."""
import json
import subprocess
import sys

from odcl_bench import harness

from conftest import REPO, make_root

CELLS_RUN = """
import json, sys
sys.path.insert(0, {root!r})
from pathlib import Path
import torch
torch.set_num_threads(2)
from odcl_bench import harness
root = Path({root!r})
for cell in harness.load_bench(root)["workloads"]:
    for traced in (False, True):
        harness.run(cell["name"], 4, 0.1, traced, device="cpu", root=root)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE_RUN = """
import json, sys
sys.path.insert(0, {repo!r})
import torch
from odcl_bench import judge
from odcl_bench.reference import convex, kmeans, sketch
a = sketch(torch.randn(64, 4), torch.randn(4, 3))
convex.cluster(a, 0.01, iters=5, tol=1e-7)
kmeans.cluster(a, 4, iters=5, tol=1e-8, generator=torch.Generator())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _modules(code: str) -> set:
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, check=True)
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_every_cell_loads_neither_jax_nor_the_reference_package(tmp_path):
    loaded = _modules(CELLS_RUN.format(root=str(make_root(tmp_path))))
    assert "repro_torch" in loaded
    assert not loaded & set(harness.BANNED)


def test_the_reference_loads_nothing_of_the_program():
    loaded = _modules(REFERENCE_RUN.format(repo=str(REPO)))
    assert not loaded & (set(harness.BANNED) | {"repro_torch"})


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    assert "repro_torch" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "repro.core", object())
    monkeypatch.setitem(sys.modules, "jaxlib_shim", object())
    assert harness.banned_modules() == ["repro"]
