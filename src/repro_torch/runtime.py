"""Host and numerics settings of the port (the counterpart of
``repro/runtime.py``).

This module imports neither jax nor anything of ``repro``, and imports
torch only inside the functions that need it, so a driver can call it
before anything heavy loads::

    from repro_torch import runtime
    runtime.apply_env_presets()      # reads REPRO_CPU_THREADS
    runtime.pin_cpu_threads(1)       # one host thread, e.g. many workers

Environment variables read by :func:`apply_env_presets`:

``REPRO_CPU_THREADS``  -- pin the host thread pools (OMP / MKL / OpenBLAS
                          and torch's intra- and inter-op pools) to N.
``REPRO_PLATFORM``, ``REPRO_X64``, ``REPRO_HOST_DEVICES``,
``REPRO_XLA_FLAGS``    -- JAX settings with no meaning here: each draws
                          a warning and changes nothing.  The device comes
                          from the entry points' ``device=`` argument.

The reference's JAX-only setters are not ported:

* ``jax_imported``: the port never imports jax;
* ``merge_xla_flags`` / ``add_xla_flags``: torch reads no XLA flags;
* ``set_platform``: the device is ``device=`` (``repro_torch.device``);
* ``enable_x64``: torch takes each tensor's dtype as given;
* ``set_host_device_count``: torch has no fake host devices.

:func:`fp32_exact` turns TF32 off (the reference's products are fp32
with fp32 accumulation); ``device.resolve_device`` calls it whenever an
entry point resolves a CUDA device.
"""
from __future__ import annotations

import contextlib
import os
import warnings

THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS",
               "VECLIB_MAXIMUM_THREADS", "NUMEXPR_NUM_THREADS")
# the reference's JAX settings, which the port reads only to refuse
JAX_ONLY_VARS = ("REPRO_PLATFORM", "REPRO_X64", "REPRO_HOST_DEVICES",
                 "REPRO_XLA_FLAGS")
_INTEROP_TOO_LATE = "cannot set number of interop threads"


def pin_cpu_threads(n: int) -> bool:
    """Pin every host thread pool to ``n`` threads: the OMP / OpenBLAS /
    MKL / vecLib / numexpr variables (for pools started later, and
    child processes), torch's intra-op pool, and its inter-op pool while
    that can still be set.  Returns whether the inter-op pool was set:
    torch refuses once inter-op work has started in the process, or once
    it was set before."""
    import torch

    n = int(n)
    if n < 1:
        raise ValueError("thread count must be >= 1")
    for var in THREAD_VARS:
        os.environ[var] = str(n)
    torch.set_num_threads(n)
    if torch.get_num_interop_threads() == n:
        return True
    try:
        torch.set_num_interop_threads(n)
    except RuntimeError as err:
        if _INTEROP_TOO_LATE not in str(err):
            raise
        return False
    return True


@contextlib.contextmanager
def pinned_threads(n: int = 1):
    """Pin the host thread pools to ``n`` (:func:`pin_cpu_threads`) for
    the block, then restore the intra-op count and the variables as they
    were.  The inter-op pool cannot be changed back once set, and stays.
    Yields whether the inter-op pool was set."""
    import torch

    threads = torch.get_num_threads()
    saved = {var: os.environ.get(var) for var in THREAD_VARS}
    try:
        yield pin_cpu_threads(n)
    finally:
        torch.set_num_threads(threads)
        for var, value in saved.items():
            if value is None:
                os.environ.pop(var, None)
            else:
                os.environ[var] = value


def fp32_exact() -> None:
    """fp32 products with fp32 accumulation: TF32 off for cuBLAS and
    cuDNN, and the ``highest`` matmul precision."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def apply_env_presets() -> dict:
    """Apply the ``REPRO_*`` overrides (see the module docstring).
    Returns what was applied: ``{}`` when nothing is set, so calling it
    unconditionally is free.  The JAX-only variables draw a warning and
    are not applied."""
    applied: dict = {}
    for var in JAX_ONLY_VARS:
        if os.environ.get(var):
            warnings.warn(f"{var} has no meaning for repro_torch and is "
                          "ignored (the device comes from device=)",
                          RuntimeWarning, stacklevel=2)
    threads = os.environ.get("REPRO_CPU_THREADS")
    if threads:
        pin_cpu_threads(int(threads))
        applied["cpu_threads"] = int(threads)
    return applied
