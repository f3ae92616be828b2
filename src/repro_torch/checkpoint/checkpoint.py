"""Host checkpointing of parameter trees in the reference's file format
(the port of ``repro/checkpoint/checkpoint.py``), atomic writes.

Layout: ``<dir>/step_<n>.ckpt``, each a compressed msgpack map of
``{path: {dtype, shape, data}}``: the "/"-joined key path of every leaf
(``layers/attn/wq``), its numpy dtype name (``bfloat16`` too), its shape
and its raw little-endian bytes.  Either package reads the other's
files.  The port writes zlib; it reads zlib, and zstd where the
``zstandard`` module imports (the reference writes zstd when it can).
The msgpack subset is the port's own (``msgpack_lite``).

A federation whose client axis is sharded over a mesh (``Shard(0)``
DTensors, ``sharding/clients.py``) is saved as one file of the whole
stack, the same bytes as the unmeshed tree's: each leaf's rows are
gathered and rank 0 writes.  Restored onto a ``Shard(0)`` template, each
rank keeps its own rows.
"""
from __future__ import annotations

import os
import re
import zlib

import torch

from repro_torch.checkpoint.msgpack_lite import packb, unpackb
from repro_torch.sharding.clients import tree_axis
from repro_torch.utils import tree_leaves_with_path, tree_map

try:                              # optional: only to read zstd files
    import zstandard
except ImportError:               # pragma: no cover - env-dependent
    zstandard = None

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "float16": torch.float16, "bfloat16": torch.bfloat16,
           "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
           "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _decompress(blob: bytes) -> bytes:
    if blob[:4] == _ZSTD_MAGIC:
        if zstandard is None:
            raise RuntimeError("checkpoint is zstd-compressed but the "
                               "'zstandard' module is unavailable")
        return zstandard.ZstdDecompressor().decompress(blob)
    return zlib.decompress(blob)


def _record(leaf: torch.Tensor) -> dict:
    t = leaf.detach().to("cpu").contiguous()
    if t.dtype not in _NAMES:
        raise TypeError(f"no checkpoint dtype for {t.dtype}")
    data = t.reshape(-1).view(torch.uint8).numpy().tobytes()
    return {"dtype": _NAMES[t.dtype], "shape": list(t.shape), "data": data}


def save_checkpoint(ckpt_dir: str, step: int, tree) -> str:
    """Write ``tree`` as ``<ckpt_dir>/step_<step>.ckpt``; returns the path.
    A ``Shard(0)`` tree is gathered leaf by leaf and written by rank 0;
    every rank returns once the file is in place."""
    axis = tree_axis(tree)
    records = {}
    for name, leaf in tree_leaves_with_path(tree):
        whole = axis.full(leaf)
        if axis.rank == 0:
            records[name] = _record(whole)
        del whole
    path = os.path.join(ckpt_dir, f"step_{step}.ckpt")
    if axis.rank == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(zlib.compress(packb(records), 6))
        os.replace(tmp, path)
    axis.barrier()
    return path


def _tensor(rec: dict) -> torch.Tensor:
    dtype = _DTYPES.get(rec["dtype"])
    if dtype is None:
        raise TypeError(f"checkpoint dtype {rec['dtype']!r} is not supported")
    if not rec["data"]:
        return torch.empty(rec["shape"], dtype=dtype)
    raw = torch.frombuffer(bytearray(rec["data"]), dtype=torch.uint8)
    return raw.view(dtype).reshape(rec["shape"])


def restore_checkpoint(ckpt_dir: str, step: int, tree_template):
    """Read step ``step`` into the structure of ``tree_template`` (its
    keys; the stored shapes and dtypes win, so a single-model template
    restores a stacked federated checkpoint).  Returns CPU tensors; onto
    a ``Shard(0)`` template, ``Shard(0)`` DTensors of each rank's rows on
    the mesh's device."""
    path = os.path.join(ckpt_dir, f"step_{step}.ckpt")
    with open(path, "rb") as f:
        stored = unpackb(_decompress(f.read()))
    axis = tree_axis(tree_template)
    leaves = []
    for p, _ in tree_leaves_with_path(tree_template):
        t = _tensor(stored[p])
        if axis.mesh is not None:   # (a plain template's leaves may be 0-d)
            t = axis.place(axis.local_rows(t, t.shape[0]), t.shape[0])
        leaves.append(t)
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree_template)


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := re.match(r"step_(\d+)\.ckpt$", f))]
    return max(steps) if steps else None
