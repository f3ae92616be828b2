"""Roofline terms of a step (the port of ``repro/roofline/analysis.py``).

    compute term    = flops / peak_flops
    memory term     = bytes / hbm_bw
    collective term = collective bytes / link_bw

all per device.  The reference reads flops and bytes from XLA's
``cost_analysis()`` and parses the collective bytes out of the
post-SPMD HLO text (``collective_bytes_from_hlo``).  One card has no
collectives and the port compiles no HLO, so that parser has no
counterpart here: :func:`roofline_terms` takes the collectives as a dict
(bytes per kind plus ``"_counts"``), which the multi-device dry run
supplies, and the flops and bytes as a ``cost`` dict.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.utils import tree_leaves_with_path


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float        # per chip
    hbm_bw: float            # bytes/s per chip
    link_bw: float           # bytes/s per chip-to-chip link, one direction


HW_V5E = Hardware(name="tpu-v5e", peak_flops=197e12, hbm_bw=819e9,
                  link_bw=50e9)
# NVIDIA's H100 SXM data sheet: 989 TFLOP/s bf16 dense on the tensor
# cores, 3.35 TB/s HBM3, NVLink 4 at 450 GB/s a direction per GPU (the
# sheet's 900 GB/s counts both directions).
HW_H100 = Hardware(name="h100-sxm-bf16", peak_flops=989e12, hbm_bw=3.35e12,
                   link_bw=450e9)
# the same card at fp32 outside the tensor cores, 67 TFLOP/s: every
# engine kernel computes in fp32 on the CUDA cores
HW_H100_FP32 = Hardware(name="h100-sxm-fp32", peak_flops=67e12,
                        hbm_bw=3.35e12, link_bw=450e9)


# ------------------------------------------------------------ model flops

def active_param_count(params_shape, n_experts: int = 0,
                       top_k: int = 0) -> tuple[int, int]:
    """(total, active) parameter counts of a parameter tree (only the
    leaves' shapes are read, so ``device="meta"`` tensors do).

    Expert leaves (paths holding 'moe' and 'w_in' / 'w_out') add
    total * top_k / E to the active count; everything else is fully
    active.  The leaves are visited in the reference's order, so the
    float sum rounds as the reference's does."""
    total = 0
    active = 0.0
    for path, leaf in tree_leaves_with_path(params_shape):
        n = math.prod(leaf.shape)
        total += n
        if ("moe" in path) and ("w_in" in path or "w_out" in path):
            active += n * (top_k / max(1, n_experts))
        else:
            active += n
    return total, int(active)


def model_flops(cfg, shape, params_shape) -> float:
    """6 N_active D for training; 2 N_active tokens for a forward
    (prefill over the sequence, decode one token a row)."""
    _, active = active_param_count(params_shape, cfg.n_experts, cfg.top_k)
    if shape.kind == "train":
        return 6.0 * active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * active * shape.global_batch * shape.seq_len
    return 2.0 * active * shape.global_batch


@dataclasses.dataclass
class RooflineReport:
    """Three-term roofline for one (arch, shape, mesh), per device.

    The terms are per-device quantities over per-chip rates; the global
    flops (per device x chips) are reported beside the model's flops for
    the useful-flop ratio."""
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device_hbm: float
    coll_bytes_per_device: float
    collective_detail: dict
    model_flops_: float
    compute_s: float
    memory_s: float
    collective_s: float
    peak_bytes_per_device: Optional[float] = None

    @property
    def hlo_flops_global(self) -> float:
        return self.flops_per_device * self.chips

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flop_ratio(self) -> float:
        g = self.hlo_flops_global
        return self.model_flops_ / g if g else float("nan")

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_gflops_global": self.hlo_flops_global / 1e9,
            "model_gflops": self.model_flops_ / 1e9,
            "hbm_gbytes_per_dev": self.bytes_per_device_hbm / 1e9,
            "coll_gbytes_per_dev": self.coll_bytes_per_device / 1e9,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "useful_flop_ratio": self.useful_flop_ratio,
        }


def roofline_terms(*, arch: str, shape, mesh_name: str, chips: int,
                   cost: dict, collectives: dict, cfg, params_shape,
                   hw: Hardware = HW_H100,
                   bytes_per_device: float | None = None) -> RooflineReport:
    """The report from per-device ``cost`` (``"flops"``, ``"bytes
    accessed"``) and ``collectives`` (payload bytes per kind and
    ``"_counts"``, as the reference's HLO parse returns them)."""
    flops = float(cost.get("flops", 0.0))
    nbytes = float(cost.get("bytes accessed", 0.0))
    coll_total = float(sum(v for k, v in collectives.items()
                           if not k.startswith("_")))
    return RooflineReport(
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        flops_per_device=flops, bytes_per_device_hbm=nbytes,
        coll_bytes_per_device=coll_total, collective_detail=collectives,
        model_flops_=model_flops(cfg, shape, params_shape),
        compute_s=flops / hw.peak_flops,
        memory_s=nbytes / hw.hbm_bw,
        collective_s=coll_total / hw.link_bw,
        peak_bytes_per_device=bytes_per_device,
    )
