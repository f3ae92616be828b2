"""Where the port's entry points run: on CUDA unless the caller asks
for the CPU.  Resolving a CUDA device also turns TF32 off
(``runtime.fp32_exact``), so every path computes fp32 products in fp32
without its caller's help."""
from __future__ import annotations

import subprocess

import torch

from repro_torch.runtime import fp32_exact


def resolve_device(device=None) -> torch.device:
    """``None`` means the current CUDA device and raises when there is
    none; an explicit ``"cpu"`` runs the kernels' plain PyTorch versions.
    Never falls back from CUDA to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch path "
                "on the CPU")
        fp32_exact()
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        fp32_exact()
    elif dev.type != "cpu":
        raise ValueError(f"repro_torch runs on cuda or cpu, not {dev}")
    return dev


def card_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them, or
    ``"cpu"`` for a CPU device."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", f"--id={device.index or 0}",
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]
