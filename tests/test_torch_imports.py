"""What the port may import, and where its entry points run.

* No file of ``src/repro_torch`` and not ``chip_smoke.py`` imports JAX
  or anything of the reference package ``repro``.
* The dispatch in ``kernels/ops.py`` has no environment switch and no
  ``try`` that could send CUDA work to the plain versions.
* Entry points called without ``device=`` on a machine without CUDA
  raise instead of running on the CPU.
* A CUDA tensor handed to ``ops`` never reaches the plain version.
"""
import ast
from pathlib import Path

import pytest
import torch

from repro_torch.core.engine.aggregate import one_shot_aggregate_device
from repro_torch.core.engine.session import AggregationSession
from repro_torch.device import resolve_device
from repro_torch.interop import state_from_numpy
from repro_torch.kernels import kmeans_assign as tassign
from repro_torch.kernels import ops
from repro_torch.kernels import pairwise_l2 as tpairwise
from repro_torch.launch import simulate as tsimulate

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path) -> list:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_port_files_exist():
    assert (PORT / "kernels" / "csrc" / "pairwise_l2.cu").exists()
    assert (PORT / "kernels" / "csrc" / "kmeans_assign.cu").exists()
    assert len(PORT_FILES) > 10 and PORT_FILES[-1].exists()


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_dispatch_has_no_switch_and_no_fallback():
    for name in ("ops.py", "pairwise_l2.py", "kmeans_assign.py"):
        tree = ast.parse((PORT / "kernels" / name).read_text())
        for node in ast.walk(tree):
            assert not isinstance(node, ast.Try), name
            assert not (isinstance(node, (ast.Attribute, ast.Name))
                        and getattr(node, "attr", getattr(node, "id", ""))
                        in ("environ", "getenv")), name


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_refuses_a_silent_cpu_default(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_entry_points_raise_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        AggregationSession(8)
    state = state_from_numpy({"theta": torch.zeros((4, 2)).numpy()}, "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        one_shot_aggregate_device(state, k=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsimulate.simulate(clients=8, clusters=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsimulate.main(["--clients", "8", "--clusters", "2"])


def test_cuda_tensors_never_reach_the_plain_version(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")

    def refuse(*_):
        raise AssertionError("plain version called with CUDA tensors")

    monkeypatch.setattr(tpairwise, "pairwise_sqdist_ref", refuse)
    monkeypatch.setattr(tassign, "kmeans_assign_ref", refuse)
    a = torch.randn((20, 8), device="cuda")
    b = torch.randn((3, 8), device="cuda")
    assert ops.pairwise_sqdist(a, b).is_cuda
    assert all(t.is_cuda for t in ops.kmeans_assign(a, b))
