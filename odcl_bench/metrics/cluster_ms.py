"""p50 of the program's cluster stage span (``session.finalize.cluster
.execute.ms`` or ``session.refinalize.cluster.execute.ms`` in
``repro_torch.obs``; the stage synchronizes its stream before the span
closes)."""
from odcl_bench.harness import percentile


def read(ctx):
    values = ctx["spans"].get(f"{ctx['stage']}.cluster.execute.ms")
    return percentile(values, 50.0) if values else None
