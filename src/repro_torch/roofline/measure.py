"""Roofline measurement orchestration (the port of
``repro/roofline/measure.py``).

The reference calibrates: XLA's cost model counts a ``while`` body ONCE
(not x trip count), so it lowers UNROLLED variants of an architecture at
L in {2, 4} (direct attention, single-chunk mLSTM and SSM, no inner
loops) and extrapolates

    cost(L) = cost(2) + (L - 2)/2 * (cost(4) - cost(2))

which is exact for any cost linear in depth (per-layer work plus
depth-independent embedding/head/optimizer work).  The port keeps the
same calibration and the same row, though its dry run counts every op
as it runs (``ShardCostMode``), loops included: its lerp equals a direct
count at the full depth, which is what its test holds it to.
Memory-fit numbers (peak bytes per rank) come from the full-depth
deploy run (``dryrun.lower_one``).

Conventions:
  * the flops come from the direct variant (materialised attention);
    bytes and collectives from the deploy variant (chunked attention);
  * flops are matmul flops (``torch.utils.flop_counter``); XLA counts
    elementwise flops too.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.launch import inputs as inp
from repro_torch.launch.mesh import mesh_name
from repro_torch.models import transformer as tr
from repro_torch.roofline.analysis import (
    HW_H100,
    RooflineReport,
    model_flops,
)


def _cal_config(cfg, n_layers: int, *, direct: bool):
    """Calibration variant: direct=True removes ALL inner loops;
    direct=False keeps the deploy chunked attention."""
    if direct:
        return dataclasses.replace(
            cfg, n_layers=n_layers, attn_chunk=0, mlstm_chunk=0, ssm_chunk=0)
    return dataclasses.replace(cfg, n_layers=n_layers)


def _extract(costs) -> dict:
    coll = costs.collective_bytes()
    coll_total = float(sum(v for k, v in coll.items()
                           if not k.startswith("_")))
    return {"flops": float(costs.flops), "bytes": float(costs.bytes),
            "coll": coll_total, "coll_detail": coll}


def _lerp(v2: float, v4: float, L: int) -> float:
    return v2 + (L - 2) / 2.0 * (v4 - v2)


def measure_combo(arch: str, shape_name: str, mesh, *, remat: str = "full",
                  deploy_info: dict | None = None, lower_one=None,
                  cfg_override=None, layout: str = "tp_fsdp", shape=None):
    """Calibrated roofline for one (arch, shape) on ``mesh``.

    ``deploy_info`` -- optional result of the full-depth dry run (its
    peak fills the memory-fit column).  ``shape`` overrides
    ``INPUT_SHAPES[shape_name]``.  Returns (RooflineReport, info dict) or
    (None, skip info).
    """
    if lower_one is None:
        from repro_torch.launch.dryrun import lower_one as _lo
        lower_one = _lo
    cfg = cfg_override or get_config(arch)
    shape = shape or INPUT_SHAPES[shape_name]
    ok, reason = inp.shape_supported(cfg, shape)
    if not ok:
        return None, {"arch": arch, "shape": shape_name, "status": "SKIP",
                      "reason": reason}

    cals = {}        # direct-attention cal: flops
    dcals = {}       # deploy (chunked) cal: bytes + collectives
    for L in (2, 4):
        ccfg = _cal_config(cfg, L, direct=True)
        costs, _ = lower_one(arch, shape_name, mesh=mesh, cfg_override=ccfg,
                             unroll=True, remat=remat, layout=layout,
                             shape=shape)
        cals[L] = _extract(costs)
        dcfg = _cal_config(cfg, L, direct=False)
        if dcfg == ccfg:
            dcals[L] = cals[L]      # decode paths have no inner loops
        else:
            costs, _ = lower_one(arch, shape_name, mesh=mesh,
                                 cfg_override=dcfg, unroll=True, remat=remat,
                                 layout=layout, shape=shape)
            dcals[L] = _extract(costs)

    L = cfg.n_layers
    flops = _lerp(cals[2]["flops"], cals[4]["flops"], L)
    nbytes = _lerp(dcals[2]["bytes"], dcals[4]["bytes"], L)
    coll = _lerp(dcals[2]["coll"], dcals[4]["coll"], L)

    scfg = inp.serve_config(cfg, shape) if shape.kind == "decode" else cfg
    params_sds = tr.abstract_params(scfg)
    chips = mesh.size()
    name = mesh_name(mesh)
    report = RooflineReport(
        arch=arch, shape=shape_name, mesh=name, chips=chips,
        flops_per_device=flops, bytes_per_device_hbm=nbytes,
        coll_bytes_per_device=coll,
        collective_detail={"cal_L2": cals[2]["coll_detail"]["_counts"],
                           "cal_L4": cals[4]["coll_detail"]["_counts"]},
        model_flops_=model_flops(scfg, shape, params_sds),
        compute_s=flops / HW_H100.peak_flops,
        memory_s=nbytes / HW_H100.hbm_bw,
        collective_s=coll / HW_H100.link_bw,
        peak_bytes_per_device=(deploy_info or {}).get("peak_bytes_per_device"),
    )
    info = {"arch": arch, "shape": shape_name, "status": "OK",
            "mesh": name, "roofline": report.row(),
            "cal": {str(k): {kk: vv for kk, vv in v.items()
                             if kk != "coll_detail"}
                    for k, v in cals.items()}}
    return report, info
