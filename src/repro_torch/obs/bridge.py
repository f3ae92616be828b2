"""The bridge from ``obs`` spans to the ``torch.profiler`` trace.

While a profiler records, every span also opens a host range of its
name on its thread, so the trace's host timeline nests the program's
spans as ``obs`` nests them, and a reader of the trace can name the
device's idle gaps by the span the host was in.  The range is
``torch._C._profiler._RecordFunctionFast``, the one ``torch._dynamo``
times its host work with: a ``torch.profiler.record_function`` is a
user annotation, which the profiler also copies onto the device's rows
over the range's kernels, and such a copy would read as device work.

``obs/__init__.py`` installs :func:`host_range` as ``obs/core.py``'s
hook where torch imports.
"""
from __future__ import annotations

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler


def host_range(name: str):
    """An open host range named ``name`` while a profiler records, else
    ``None``."""
    if not _profiler._is_profiler_enabled:
        return None
    host = _RecordFunctionFast(name)
    host.__enter__()
    return host
