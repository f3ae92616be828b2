"""p50 of the program's mean stage span (``session.finalize.mean
.execute.ms`` in ``repro_torch.obs``; a refinalize runs the same
stage)."""
from odcl_bench.harness import percentile


def read(ctx):
    values = ctx["spans"].get("session.finalize.mean.execute.ms")
    return percentile(values, 50.0) if values else None
