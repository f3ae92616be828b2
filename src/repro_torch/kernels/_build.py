"""Build the hand-written CUDA kernels at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its
own by ``nvcc`` for Hopper (``sm_90a``) into a shared library, loaded
with ``ctypes``.  No PyTorch header is included, so a build takes
seconds.  Libraries go to ``kernels/build/`` (git-ignored) under a name
keyed by a hash of the source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source or header is rebuilt and an unchanged one
is reused.  ``build()`` starts one
``nvcc`` per missing library, all at once, and waits for all of them.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
KERNELS = ("pairwise_l2", "kmeans_assign", "group_prox",
           "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VP, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FLOAT = ctypes.c_float
_SIGNATURES = {
    "pairwise_l2": {
        # a, b, out, m, k, d, stream
        "pairwise_sqdist_f32": [_VP, _VP, _VP, _INT, _INT, _INT, _VP],
        # a, b, out, m, k, d, rows a tile, stages, grid, stream
        "pairwise_sqdist_stream_f32": [_VP, _VP, _VP, _LL, _INT, _INT, _INT,
                                       _INT, _INT, _VP],
        # a, b, out, nb, m, k, d, stream
        "pairwise_sqdist_batched_f32": [_VP, _VP, _VP, _INT, _INT, _INT,
                                        _INT, _VP],
    },
    "kmeans_assign": {
        # points, centers, labels, sums, counts, m, k, d, stream
        "kmeans_assign_small_f32": [_VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT,
                                    _VP],
        # points, centers, labels, dscratch, iscratch, tickets, sums,
        # counts, m, k, d, rows a tile, stages, smem_part, grid, stream
        "kmeans_assign_stream_f32": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                                     _LL, _INT, _INT, _INT, _INT, _INT, _INT,
                                     _VP],
    },
    "group_prox": {
        # v, radius, out, e, d, radius stride, stream
        "group_ball_proj_f32": [_VP, _VP, _VP, _LL, _INT, _LL, _VP],
        # v, radius, out, b, e, d, radius strides (b, e), stream
        "group_ball_proj_batched_f32": [_VP, _VP, _VP, _LL, _LL, _INT, _LL,
                                        _LL, _VP],
        # nu (stepped in place), radius, b, e, d, radius strides (b, e),
        # u, m, i_idx, j_idx, eta, moved, stream
        "ama_step_f32": [_VP, _VP, _LL, _LL, _INT, _LL, _LL, _VP, _LL, _VP,
                         _VP, _VP, _VP, _VP],
        # a, nu, head starts, head order, tail starts, tail order, u, b, m,
        # e, d, stream
        "ama_gather_back_f32": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _LL, _LL,
                                _LL, _INT, _VP],
    },
    "flash_attention": {
        # q, k, v, o, strides[12], batch, h, hkv, sq, skv, dh, causal,
        # window, scale, dtype, stream
        "flash_attention_fwd": [_VP, _VP, _VP, _VP, ctypes.POINTER(_LL),
                                _INT, _INT, _INT, _INT, _INT, _INT, _INT,
                                _INT, _FLOAT, _INT, _VP],
        # counts[2]: launches of the tensor-core and CUDA-core kernels
        "flash_attention_kernel_launches": [ctypes.POINTER(_LL)],
    },
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or CUDA_HOME set)")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives for its current
    source and flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=KERNELS) -> dict:
    """Compile every missing library of ``names`` in parallel.  Returns
    ``{name: seconds}`` (0.0 for a library that was already built);
    raises with the compiler's output if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    running = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True), tmp, out)
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out) in running.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for csrc/{name}.cu:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)      # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use, with
    every exported function's argument types declared."""
    build((name,))
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, argtypes in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what} failed with cudaError_t {err}")


def ptxas_usage(name: str) -> dict:
    """Registers and spill bytes of every kernel of ``csrc/<name>.cu``, as
    ``-Xptxas -v`` reported them in the build's log:
    ``{mangled name: {"registers": n, "spill_stores": n, "spill_loads": n}}``."""
    log = library_path(name).with_suffix(".log").read_text()
    usage, fn = {}, None
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '([^']+)'", line)
        if found:
            fn = found.group(1)
            usage[fn] = {}
            continue
        if fn is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill:
            usage[fn]["spill_stores"] = int(spill.group(1))
            usage[fn]["spill_loads"] = int(spill.group(2))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            usage[fn]["registers"] = int(regs.group(1))
    return usage
