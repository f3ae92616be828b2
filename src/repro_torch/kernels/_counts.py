"""Launch counters of the kernel wrappers, safe across threads.

Each wrapper carries ``launches`` (and, where it picks a kernel by shape,
``by_variant``); ``count_launch`` adds one where the wrapper has
launched, under one lock, so that routes on a batcher thread and a round
on a worker thread never lose a count.  ``kernels/ops.py`` reads and
resets the counters under the same lock.
"""
from __future__ import annotations

import threading

LOCK = threading.Lock()


def count_launch(wrapper, variant: str | None = None) -> None:
    """One launch of ``wrapper``'s kernel: its ``launches`` and, where it
    keeps them, its ``by_variant[variant]``."""
    with LOCK:
        wrapper.launches += 1
        if variant is not None:
            wrapper.by_variant[variant] += 1
