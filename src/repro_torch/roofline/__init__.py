"""repro_torch.roofline: hardware peaks, model flops, the roofline
report and the dry run's per-rank cost count (``analysis``), each
kernel's work from its shapes (``kernel_costs``), the engine's
achieved-vs-peak rows (``engine_costs``), and the calibrated sweep over
the dry run (``measure``, ``run_sweep``).  The port of
``repro/roofline``."""
from repro_torch.roofline.analysis import (
    HW_H100,
    HW_H100_FP32,
    HW_V5E,
    Hardware,
    RooflineReport,
    ShardCostMode,
    active_param_count,
    model_flops,
    roofline_terms,
)
from repro_torch.roofline.engine_costs import (
    HW_CPU,
    achieved_vs_peak,
    detect_hardware,
    engine_kernel_report,
    hardware_info,
    kernel_probe,
    program_rows_from_snapshot,
)

__all__ = [
    "HW_CPU",
    "HW_H100",
    "HW_H100_FP32",
    "HW_V5E",
    "Hardware",
    "RooflineReport",
    "ShardCostMode",
    "achieved_vs_peak",
    "active_param_count",
    "detect_hardware",
    "engine_kernel_report",
    "hardware_info",
    "kernel_probe",
    "model_flops",
    "program_rows_from_snapshot",
    "roofline_terms",
]
