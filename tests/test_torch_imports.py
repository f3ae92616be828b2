"""What the port may import, and where its entry points run.

* No file of ``src/repro_torch`` and not ``chip_smoke.py`` imports JAX
  or anything of the reference package ``repro``, nor ``msgpack`` (the
  card's machine lacks it: the checkpoint carries its own subset); the
  checkpoint imports ``zstandard`` only inside the reference's optional
  ``try``.
* The dispatch in ``kernels/ops.py`` has no environment switch and no
  ``try`` that could send CUDA work to the plain versions.
* Entry points called without ``device=`` on a machine without CUDA
  raise instead of running on the CPU (the host clustering families and
  ``odcl`` too, when handed numpy points).
* A CUDA tensor handed to ``ops`` never reaches the plain version.
* No file of the port names PyTorch's fused attention: the prefill's
  attention is the port's own kernel.
"""
import ast
import importlib
from pathlib import Path

import pytest
import torch

from repro_torch import runtime
from repro_torch.core import federated as tfederated
from repro_torch.core.clustering import api as tapi
from repro_torch.core.engine.aggregate import one_shot_aggregate_device
from repro_torch.core.engine.session import AggregationSession
from repro_torch.device import resolve_device
from repro_torch.interop import state_from_numpy
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import kmeans_assign as tassign
from repro_torch.kernels import ops
from repro_torch.kernels import pairwise_l2 as tpairwise
from repro_torch.launch import serve as tserve
from repro_torch.launch import simulate as tsimulate
from repro_torch.models import init_decode_cache, init_params
from repro_torch.serving import RouteServer
from repro_torch.serving import loadgen as tloadgen
from repro_torch.utils import tree_leaves

# the module: ``repro_torch.core.odcl`` is also the package's name for the
# function, as in the reference
todcl = importlib.import_module("repro_torch.core.odcl")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One host thread: the tensors here are small, and parallel test
    workers must not oversubscribe the CPU."""
    with runtime.pinned_threads(1):
        yield


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
    return top in ("jax", "jaxlib", "repro", "msgpack")


def test_port_files_exist():
    for name in ("pairwise_l2", "kmeans_assign", "group_prox",
                 "flash_attention"):
        assert (PORT / "kernels" / "csrc" / f"{name}.cu").exists()
        assert (PORT / "kernels" / f"{name}.py").exists()
    for rel in ("configs/base.py", "configs/qwen2_0_5b.py",
                "models/layers.py", "models/attention.py",
                "models/transformer.py", "models/__init__.py",
                "launch/serve.py", "interop.py",
                "core/engine/staleness.py", "serving/__init__.py",
                "serving/batching.py", "serving/server.py",
                "serving/loadgen.py", "kernels/_counts.py",
                "core/clustering/admissible.py", "core/clustering/gradient.py",
                "core/clustering/kmeans.py", "core/engine/aggregators.py",
                "core/odcl.py", "core/erm.py", "optim/adamw.py",
                "obs/sinks.py", "utils/prng.py", "scenarios/__init__.py",
                "scenarios/api.py", "scenarios/library.py",
                "data/__init__.py", "data/synthetic.py",
                "core/engine/hierarchy.py", "core/oracles.py",
                "core/theory.py", "core/ifca.py", "core/methods.py",
                "core/federated_methods.py", "launch/train.py",
                "launch/steps.py", "data/lm_data.py", "optim/sgd.py",
                "optim/schedule.py", "checkpoint/__init__.py",
                "checkpoint/checkpoint.py", "checkpoint/msgpack_lite.py",
                "models/moe.py", "models/recurrent.py",
                "launch/mesh.py", "launch/inputs.py", "launch/dryrun.py",
                "sharding/__init__.py", "sharding/specs.py",
                "sharding/activations.py", "roofline/measure.py",
                "roofline/run_sweep.py"):
        assert (PORT / rel).exists(), rel
    assert len(PORT_FILES) > 10 and PORT_FILES[-1].exists()


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_zstandard_only_behind_the_optional_import():
    """Only the checkpoint names ``zstandard``, imported inside a ``try``
    whose ``except ImportError`` leaves it ``None`` (zstd files are then
    refused, zlib ones read), as the reference does."""
    for path in PORT_FILES:
        tree = ast.parse(path.read_text())
        guarded = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Try) and any(
                    isinstance(h.type, ast.Name) and h.type.id == "ImportError"
                    for h in node.handlers):
                guarded |= {id(n) for stmt in node.body
                            for n in ast.walk(stmt)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import) and any(
                    a.name.split(".")[0] == "zstandard" for a in node.names):
                assert path.name == "checkpoint.py", path
                assert id(node) in guarded, path


def test_dispatch_has_no_switch_and_no_fallback():
    for name in ("kernels/ops.py", "kernels/pairwise_l2.py",
                 "kernels/kmeans_assign.py", "kernels/group_prox.py",
                 "kernels/flash_attention.py", "models/attention.py"):
        tree = ast.parse((PORT / name).read_text())
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
    with pytest.raises(RuntimeError, match="CUDA"):
        tsimulate.main(["--clients", "8", "--clusters", "2", "--churn", "2",
                        "--qps-callers", "2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tsimulate.main(["--clients", "8", "--clusters", "2", "--task",
                        "logistic", "--init", "spectral", "--aggregator",
                        "median", "--trace", "unused.jsonl"])
    thetas = torch.zeros((6, 3)).numpy()
    with pytest.raises(RuntimeError, match="CUDA"):
        todcl.odcl(thetas, algorithm="spectral", k=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        todcl.run_clustering(None, thetas, "kmeans", k=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tapi.get_algorithm("gradient")(None, thetas, k=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfederated.one_shot_aggregate(state, algorithm="spectral", k=2,
                                      engine="host")
    with pytest.raises(RuntimeError, match="CUDA"):
        tloadgen.main(["--clients", "64", "--duration", "0.1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tloadgen.run(clients=64, duration_s=0.1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tloadgen.build_session(clients=64, clusters=2, sketch_dim=4)

    class CudaSession:
        device = torch.device("cuda", 0)
        sketch_dim = 4

    with pytest.raises(RuntimeError, match="CUDA"):
        RouteServer(CudaSession())
    with pytest.raises(RuntimeError, match="CUDA"):
        RouteServer(object())
    cpu_session = AggregationSession(8, sketch_dim=4, device="cpu")
    assert RouteServer(cpu_session).device == torch.device("cpu")
    cfg = get_config("qwen2-0.5b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--reduced"])
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_decode_cache(cfg, 1, 8)
    model = init_params(cfg, device="cpu")
    prompts = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.generate(model, cfg, prompts, 2)
    assert tserve.generate(model, cfg, prompts, 2,
                           device="cpu")[0].shape == (1, 6)


def test_slice9_entry_points_raise_without_cuda(no_cuda, tmp_path):
    """The training and serving drivers run on the card unless asked for
    the CPU: every one raises without CUDA, and runs with ``--device cpu``
    (the driver tests run them there)."""
    from repro_torch.core.federated import init_federation
    from repro_torch.launch import train as ttrain

    cfg = get_config("qwen2-0.5b").reduced(n_layers=1, max_d_model=64,
                                           max_vocab=64)
    for argv in (["--reduced"], ["--reduced", "--method", "ifca"],
                 ["--reduced", "--engine", "device"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            ttrain.main(argv)
    for argv in (["--reduced", "--ckpt-dir", str(tmp_path)],
                 ["--reduced", "--ckpt-dir", str(tmp_path),
                  "--route-by-sketch"],
                 ["--reduced", "--server"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            tserve.main(argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsimulate.main(["--clients", "8", "--clusters", "2", "--method",
                        "ifca"])
    with pytest.raises(RuntimeError, match="CUDA"):
        init_federation(0, cfg, 2)
    state = init_federation(0, cfg, 2, device="cpu")
    assert tree_leaves(state.params)[0].device == torch.device("cpu")


def test_decode_api_entry_points_raise_without_cuda(no_cuda):
    import numpy as np

    from repro_torch.interop import kv_cache_from_numpy
    from repro_torch.models.attention import init_kv_cache
    from repro_torch.models.layers import init_mlp

    with pytest.raises(RuntimeError, match="CUDA"):
        init_kv_cache(1, 2, 8, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_mlp(torch.Generator(), 4, 8, "swiglu", torch.float32)
    ring = np.zeros((1, 2, 8, 4), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        kv_cache_from_numpy(ring, ring, 0)
    assert init_kv_cache(1, 2, 8, 4, device="cpu").pos.device.type == "cpu"
    assert kv_cache_from_numpy(ring, ring, 3, device="cpu").pos == 3
    assert init_mlp(torch.Generator(), 4, 8, "swiglu", torch.float32,
                    device="cpu")["w_in"].shape == (4, 16)


def test_slice8_entry_points_raise_without_cuda(no_cuda):
    from repro_torch.core.engine.hierarchy import (
        HierarchicalSession, hierarchical_one_shot_aggregate)
    from repro_torch.core.methods import IFCA, ODCL
    from repro_torch.scenarios import ByzantineScenario, LongtailScenario
    from repro_torch.utils import prng

    with pytest.raises(RuntimeError, match="CUDA"):
        HierarchicalSession(8, shards=2)
    state = state_from_numpy({"theta": torch.zeros((4, 2)).numpy()}, "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        hierarchical_one_shot_aggregate(state, shards=2, k=2)
    for argv in (["--scenario", "byzantine", "--byzantine-frac", "0.2"],
                 ["--shards", "2"],
                 ["--shards", "2", "--scenario", "dp", "--dp-epsilon", "8"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            tsimulate.main(["--clients", "8", "--clusters", "2"] + argv)
    pts = torch.zeros((6, 3)).numpy()
    with pytest.raises(RuntimeError, match="CUDA"):
        ODCL(k=2).fit(0, None, None, erm=lambda xs, ys: pts)
    with pytest.raises(RuntimeError, match="CUDA"):
        IFCA(k=2, loss_fn=None, grad_fn=None).fit(0, pts[None], pts[None, :, 0])
    with pytest.raises(RuntimeError, match="CUDA"):
        ByzantineScenario().honest_mask(prng.key(0), 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        LongtailScenario().population(prng.key(0), 8, 2)
    assert HierarchicalSession(8, shards=2, device="cpu").shards == 2


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_port_file_names_fused_attention(path):
    """QK^T and PV of the prefill run in the port's own kernel: no file of
    the package names PyTorch's fused attention (chip_smoke.py may time
    it beside the kernel).  cuDNN is named only to turn its TF32 off
    (``torch.backends.cudnn.allow_tf32``, ``runtime.fp32_exact``)."""
    tree = ast.parse(path.read_text())
    tf32_off = {id(node.value) for node in ast.walk(tree)
                if isinstance(node, ast.Attribute)
                and node.attr == "allow_tf32"
                and ast.unparse(node.value) == "torch.backends.cudnn"}
    for node in ast.walk(tree):
        if id(node) in tf32_off:
            continue
        names = []
        if isinstance(node, ast.Attribute):
            names.append(node.attr)
        elif isinstance(node, ast.Name):
            names.append(node.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names += [a.name.split(".")[-1] for a in node.names]
        assert "scaled_dot_product_attention" not in names, path
        assert "cudnn" not in names, path


def test_flash_dispatch_sends_a_cuda_tensor_to_the_kernel(monkeypatch):
    """Without a card: an operand that says it lies on CUDA goes to the
    kernel's wrapper, never to the plain version."""
    class OnCuda:
        device = torch.device("cuda", 0)

    def refuse(*_, **__):
        raise AssertionError("plain version called with CUDA tensors")

    launched = []
    monkeypatch.setattr(tflash, "flash_attention_ref", refuse)
    monkeypatch.setattr(tflash, "flash_attention",
                        lambda q, k, v, **kw: launched.append(kw) or q)
    q = OnCuda()
    assert ops.flash_attention(q, q, q, causal=True, window=8) is q
    assert launched == [{"causal": True, "window": 8}]


def test_cuda_tensors_never_reach_the_plain_version(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")

    def refuse(*_):
        raise AssertionError("plain version called with CUDA tensors")

    monkeypatch.setattr(tpairwise, "pairwise_sqdist_ref", refuse)
    monkeypatch.setattr(tassign, "kmeans_assign_ref", refuse)
    monkeypatch.setattr(tflash, "flash_attention_ref", refuse)
    a = torch.randn((20, 8), device="cuda")
    b = torch.randn((3, 8), device="cuda")
    assert ops.pairwise_sqdist(a, b).is_cuda
    assert all(t.is_cuda for t in ops.kmeans_assign(a, b))
    q = torch.randn((1, 4, 5, 8), device="cuda")
    k = torch.randn((1, 2, 5, 8), device="cuda")
    assert ops.flash_attention(q, k, k).is_cuda


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "grok-1-314b",
                                  "xlstm-125m", "hymba-1.5b",
                                  "hubert-xlarge", "pixtral-12b"])
def test_family_entry_points_raise_without_cuda(no_cuda, arch):
    """Every family's model entry points and CLIs run on the card
    unless asked for the CPU."""
    from repro_torch.launch import train as ttrain
    from repro_torch.models.transformer import init_tree

    cfg = get_config(arch).reduced(max_d_model=64, max_vocab=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_tree(cfg)
    if cfg.causal:
        with pytest.raises(RuntimeError, match="CUDA"):
            init_decode_cache(cfg, 1, 8)
    if cfg.input_mode == "tokens":
        with pytest.raises(RuntimeError, match="CUDA"):
            tserve.main(["--arch", arch, "--reduced"])
        with pytest.raises(RuntimeError, match="CUDA"):
            ttrain.main(["--arch", arch, "--reduced"])
    assert init_params(cfg, device="cpu").embed.device.type == "cpu"


def test_dry_run_raises_without_cuda_unless_asked_for_the_cpu(no_cuda):
    """The mesh family runs on CUDA meshes (fake tensors on the card's
    device type) unless asked for the CPU: without a card every entry
    point raises before it builds a process group."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import (
        destroy_fake_process_group,
        make_debug_mesh,
        make_production_mesh,
    )
    from repro_torch.roofline import run_sweep

    had_group = dist.is_initialized()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_debug_mesh(2, 2, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.main(["--arch", "xlstm_125m", "--shape", "long_500k"])
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.lower_one("xlstm_125m", "long_500k")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_sweep.main(["--arch", "xlstm_125m", "--shape", "long_500k",
                        "--json", "unused.jsonl"])
    assert dist.is_initialized() == had_group
    if not had_group:
        mesh = make_debug_mesh(1, 2, device="cpu")
        assert mesh.device_type == "cpu" and tuple(mesh.shape) == (1, 2)
        with pytest.raises(RuntimeError, match="2 ranks exists"):
            make_debug_mesh(2, 2, device="cpu")
        destroy_fake_process_group()
        assert not dist.is_initialized()
