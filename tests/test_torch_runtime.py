"""The port's runtime (``repro_torch/runtime.py``) against the
reference's ``tests/test_runtime.py`` where the two mean the same thing,
and the rule that every CPU test file of the port pins its threads
through it.

* ``pin_cpu_threads`` sets the reference's five thread variables and
  torch's pools, reports whether the inter-op pool could still be set,
  and rejects n < 1; ``pinned_threads`` restores what it changed.
* ``apply_env_presets`` applies ``REPRO_CPU_THREADS`` and only warns
  about the JAX variables: ``REPRO_PLATFORM=cpu`` never moves the port's
  work to the CPU.
* ``fp32_exact`` turns TF32 off, and resolving a CUDA device calls it.
* Importing the module loads neither jax, nor ``repro``, nor torch.
"""
import ast
import os
import subprocess
import sys
import warnings
from pathlib import Path

import pytest
import torch

from repro import runtime as jruntime
from repro_torch import runtime
from repro_torch.device import resolve_device
from repro_torch.launch import serve as tserve
from repro_torch.serving import loadgen as tloadgen

ROOT = Path(__file__).resolve().parents[1]
# the card-only kernel tests import no jax and run only where a card is
CARD_ONLY = {"test_torch_cuda_kernels.py"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One host thread: the tensors here are small, and parallel test
    workers must not oversubscribe the CPU."""
    with runtime.pinned_threads(1):
        yield


@pytest.fixture
def clean_env(monkeypatch):
    for var in (*runtime.THREAD_VARS, *runtime.JAX_ONLY_VARS,
                "REPRO_CPU_THREADS", "JAX_PLATFORMS", "XLA_FLAGS"):
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


@pytest.fixture
def keep_threads():
    threads = torch.get_num_threads()
    yield
    torch.set_num_threads(threads)


def test_pin_cpu_threads_sets_the_reference_variables(clean_env,
                                                      keep_threads):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jruntime.pin_cpu_threads(2)
    want = {var: os.environ[var] for var in runtime.THREAD_VARS}
    for var in runtime.THREAD_VARS:
        clean_env.delenv(var)
    assert isinstance(runtime.pin_cpu_threads(2), bool)
    assert {var: os.environ[var] for var in runtime.THREAD_VARS} == want
    assert torch.get_num_threads() == 2
    with pytest.raises(ValueError, match=">= 1"):
        runtime.pin_cpu_threads(0)


def test_pinned_threads_restores_count_and_variables(clean_env,
                                                     keep_threads):
    torch.set_num_threads(3)
    clean_env.setenv("OMP_NUM_THREADS", "7")
    with runtime.pinned_threads(1):
        assert torch.get_num_threads() == 1
        assert all(os.environ[var] == "1" for var in runtime.THREAD_VARS)
    assert torch.get_num_threads() == 3
    assert os.environ["OMP_NUM_THREADS"] == "7"
    assert all(var not in os.environ for var in runtime.THREAD_VARS[1:])
    with pytest.raises(KeyError):
        with runtime.pinned_threads(2):
            raise KeyError("the block's error passes through")
    assert torch.get_num_threads() == 3


def test_interop_pool_refusal_is_reported_not_swallowed(
        clean_env, keep_threads, monkeypatch):
    """torch refuses a second inter-op setting, or one after inter-op
    work started: that is reported as False.  Any other error raises."""
    monkeypatch.setattr(torch, "get_num_interop_threads", lambda: 4)

    def too_late(n):
        raise RuntimeError("Error: cannot set number of interop threads "
                           "after parallel work has started or "
                           "set_num_interop_threads called")

    monkeypatch.setattr(torch, "set_num_interop_threads", too_late)
    assert runtime.pin_cpu_threads(1) is False

    def broken(n):
        raise RuntimeError("something else")

    monkeypatch.setattr(torch, "set_num_interop_threads", broken)
    with pytest.raises(RuntimeError, match="something else"):
        runtime.pin_cpu_threads(1)
    monkeypatch.setattr(torch, "set_num_interop_threads", lambda n: None)
    assert runtime.pin_cpu_threads(1) is True


def test_apply_env_presets_no_overrides_is_noop(clean_env):
    assert runtime.apply_env_presets() == {}
    assert jruntime.apply_env_presets() == {}
    assert all(var not in os.environ for var in runtime.THREAD_VARS)


def test_apply_env_presets_reads_cpu_threads(clean_env, keep_threads):
    clean_env.setenv("REPRO_CPU_THREADS", "2")
    assert runtime.apply_env_presets() == {"cpu_threads": 2}
    assert torch.get_num_threads() == 2
    assert os.environ["MKL_NUM_THREADS"] == "2"


@pytest.mark.parametrize("var,value", [("REPRO_PLATFORM", "cpu"),
                                       ("REPRO_X64", "1"),
                                       ("REPRO_HOST_DEVICES", "8"),
                                       ("REPRO_XLA_FLAGS", "--xla_a=1")])
def test_jax_variables_warn_and_apply_nothing(clean_env, monkeypatch, var,
                                              value):
    clean_env.setenv(var, value)
    before = dict(os.environ)
    with pytest.warns(RuntimeWarning, match=f"{var} has no meaning"):
        assert runtime.apply_env_presets() == {}
    assert dict(os.environ) == before
    # the device still comes from device=: no CUDA means an error, not
    # the CPU, whatever REPRO_PLATFORM says
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()


@pytest.fixture
def tf32_flags():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("medium")
    yield
    torch.backends.cuda.matmul.allow_tf32 = saved[0]
    torch.backends.cudnn.allow_tf32 = saved[1]
    torch.set_float32_matmul_precision(saved[2])


def tf32_off() -> bool:
    return (not torch.backends.cuda.matmul.allow_tf32
            and not torch.backends.cudnn.allow_tf32
            and torch.get_float32_matmul_precision() == "highest")


def test_fp32_exact_turns_tf32_off(tf32_flags):
    assert not tf32_off()
    runtime.fp32_exact()
    assert tf32_off()


@pytest.mark.parametrize("device", [None, "cuda", "cuda:0"])
def test_resolving_a_cuda_device_turns_tf32_off(tf32_flags, monkeypatch,
                                                device):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device(device) == torch.device("cuda", 0)
    assert tf32_off()


def test_resolving_the_cpu_leaves_tf32_alone(tf32_flags):
    assert resolve_device("cpu") == torch.device("cpu")
    assert not tf32_off()


class Presets(Exception):
    pass


@pytest.mark.parametrize("main", [tserve.main, tloadgen.main],
                         ids=["serve", "loadgen"])
def test_clis_apply_env_presets_first(monkeypatch, main):
    """serve and loadgen apply the presets before they parse arguments,
    as the reference's modules do before jax loads."""
    def called():
        raise Presets

    monkeypatch.setattr(runtime, "apply_env_presets", called)
    with pytest.raises(Presets):
        main(["--not-an-option"])


def test_runtime_module_imports_no_jax_repro_or_torch():
    code = ("import sys; import repro_torch.runtime; "
            "bad = [m for m in ('jax', 'repro', 'torch') "
            "if m in sys.modules]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stdout.decode() + proc.stderr.decode()


def _module_fixtures(tree: ast.Module) -> list:
    """The module-scoped autouse fixtures of a test file."""
    out = []
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and any(
                "pytest.fixture" in d and "autouse=True" in d
                and "scope='module'" in d
                for d in map(ast.unparse, node.decorator_list)):
            out.append(node)
    return out


@pytest.mark.parametrize(
    "path", sorted(p for p in (ROOT / "tests").glob("test_torch_*.py")
                   if p.name not in CARD_ONLY), ids=lambda p: p.name)
def test_every_cpu_test_file_pins_through_the_runtime(path):
    """Every port test file that runs on the CPU pins its threads with
    ``runtime.pinned_threads`` in a module-scoped autouse fixture, and no
    such fixture sets a thread count of its own."""
    fixtures = _module_fixtures(ast.parse(path.read_text()))
    entered = [ast.unparse(item.context_expr) for f in fixtures
               for n in ast.walk(f) if isinstance(n, ast.With)
               for item in n.items]
    assert any(e.startswith("runtime.pinned_threads(") for e in entered), \
        path.name
    calls = [ast.unparse(n.func) for f in fixtures for n in ast.walk(f)
             if isinstance(n, ast.Call)]
    assert not [c for c in calls if c.endswith("set_num_threads")], path.name
