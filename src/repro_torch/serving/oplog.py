"""The route server's ordered log under a client mesh.

The reference serves a meshed session from one controller.  The port
runs one process a rank, so rank 0's ``RouteServer`` is the controller
and the servers of the other ranks follow it: every ingest and round
that rank 0 applied is sent to them, in the order of rank 0's ingest
lock, and they apply it in that order.  Each entry is one dict:

  * ``{"kind": "ingest", "wave", "sketches", "client_ids", "clock"}``:
    the wave as rank 0's caller passed it, and rank 0's clock after it;
  * ``{"kind": "round", "warm", "kwargs", "clock"}``: a finalize (or warm
    refinalize) with its arguments, and the clock of rank 0's snapshot;
  * ``{"kind": "close", "clock"}``: rank 0's server stopped.

An entry travels as bytes over the mesh dim's control group
(``ClientAxis.broadcast``): its size, then one ``uint8`` buffer holding
the pickled entry with every tensor and array taken out, then the raw
bytes of those (a bf16 wave crosses unchanged).  A receiver gets them
back as CPU tensors; the session moves them to its device.
"""
from __future__ import annotations

import pickle
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.sharding.clients import wait


class _Raw(NamedTuple):
    """Where a tensor's bytes lie in an entry's payload."""
    offset: int
    nbytes: int
    dtype: torch.dtype
    shape: tuple


def encode(entry: dict) -> torch.Tensor:
    """One entry as a host ``uint8`` tensor: 8 bytes of skeleton size,
    the pickled skeleton, then every tensor's bytes."""
    raw: list = []
    offset = 0

    def strip(x):
        nonlocal offset
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        if isinstance(x, torch.Tensor):
            flat = x.detach().contiguous().reshape(-1)
            raw.append(flat.view(torch.uint8).cpu())
            ref = _Raw(offset, raw[-1].numel(), x.dtype, tuple(x.shape))
            offset += ref.nbytes
            return ref
        if isinstance(x, dict):
            return {k: strip(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(strip(v) for v in x))
        if isinstance(x, (list, tuple)):
            return type(x)(strip(v) for v in x)
        return x

    skeleton = pickle.dumps(strip(entry))
    head = torch.tensor([len(skeleton)], dtype=torch.int64).view(torch.uint8)
    return torch.cat([head, torch.frombuffer(bytearray(skeleton),
                                             dtype=torch.uint8), *raw])


def decode(buf: torch.Tensor) -> dict:
    """The entry ``encode`` made, its tensors on the host."""
    n = int(buf[:8].view(torch.int64))
    base = 8 + n

    def fill(x):
        if isinstance(x, _Raw):
            part = buf[base + x.offset:base + x.offset + x.nbytes].clone()
            return part.view(x.dtype).reshape(x.shape)
        if isinstance(x, dict):
            return {k: fill(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(fill(v) for v in x))
        if isinstance(x, (list, tuple)):
            return type(x)(fill(v) for v in x)
        return x

    return fill(pickle.loads(buf[8:base].numpy().tobytes()))


class OpLog:
    """Rank 0's side (``send``) and a follower's (``receive``) of the log
    over one ``ClientAxis``'s control group.  Counts
    ``serving.log.entries`` and ``serving.log.bytes`` on every rank."""

    def __init__(self, axis):
        self.axis = axis

    def send(self, body: torch.Tensor) -> None:
        """Send one ``encode``d entry (encoded before rank 0 applies it:
        what cannot be sent is not applied)."""
        self.axis.broadcast(torch.tensor([body.numel()], dtype=torch.int64))
        self.axis.broadcast(body)
        self._count(body)

    def receive(self) -> dict:
        size = self.axis.broadcast(torch.zeros(1, dtype=torch.int64))
        body = self.axis.broadcast(torch.empty(int(size), dtype=torch.uint8))
        self._count(body)
        return decode(body)

    @staticmethod
    def _count(body: torch.Tensor) -> None:
        obs.count("serving.log.entries")
        obs.count("serving.log.bytes", body.numel())

    def close(self, body: torch.Tensor, clock: int,
              timeout: Optional[float] = None) -> tuple:
        """Rank 0: send the ``encode``d close and wait until every rank
        has applied it; returns the ``(least, largest)`` clock the ranks
        ended at.  The close and the acknowledgement are posted together,
        so a ``timeout`` (``TimeoutError``) leaves both in flight, in
        order, to end when the late ranks come."""
        ack = torch.tensor([clock, -clock], dtype=torch.int64)
        works = [self.axis.broadcast(torch.tensor([body.numel()]),
                                     async_op=True),
                 self.axis.broadcast(body, async_op=True),
                 self.axis.control_max(ack, async_op=True)]
        self._count(body)
        wait(works, timeout)
        return -int(ack[1]), int(ack[0])

    def acknowledge(self, clock: int) -> None:
        """A follower: the close applied, at ``clock`` (-1 after a
        divergence)."""
        self.axis.control_max(torch.tensor([clock, -clock],
                                           dtype=torch.int64))
