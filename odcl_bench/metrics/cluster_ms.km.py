"""``cluster_ms`` in the cells the host paces, which report no rate end to
end: the same reader, under the name that moves their end-to-end
metric (``PERF.md``)."""
from pathlib import Path

from odcl_bench.harness import reader

read = reader("cluster_ms", Path(__file__).resolve().parents[2]).read
