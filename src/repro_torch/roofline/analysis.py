"""Roofline terms of a step (the port of ``repro/roofline/analysis.py``).

    compute term    = flops / peak_flops
    memory term     = bytes / hbm_bw
    collective term = collective bytes / link_bw

all per device.  The reference reads flops and bytes from XLA's
``cost_analysis()`` and parses the collective bytes out of the
post-SPMD HLO text (``collective_bytes_from_hlo``).  The port compiles
no HLO: the dry run traces a step on DTensors over fake tensors, and
:class:`ShardCostMode`, a dispatch mode that sees each rank's local
shard ops (never the global DTensor op), counts them as they run:
matmul flops (``torch.utils.flop_counter``'s formulas, as
``FlopCounterMode`` counts them), bytes read and written, the live
bytes of the tensors the trace makes, and every functional collective
with its payload under the reference's kind names
(:meth:`ShardCostMode.collective_bytes`).  :func:`roofline_terms` takes
the flops and bytes as a ``cost`` dict and the collectives as that
dict.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import weakref
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor, unset_fake_temporarily
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

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


# ------------------------------------------------------- trace costs

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# the functional collectives a DTensor redistribution issues, by the
# reference's HLO kind names (a point-to-point shift would be a
# collective-permute; DTensor issues none).  DTensor's shard-to-shard
# all-to-all is its own op; on a CPU mesh it falls back to an all-gather
# and a chunk, and counts as that
_KIND = {
    "shard_dim_alltoall": "all-to-all",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}
# ops that only read metadata, wait, or allocate without writing
_NO_BYTES = {"wait_tensor", "empty", "empty_strided", "empty_like",
             "new_empty", "new_empty_strided", "detach", "alias",
             "lift_fresh", "_local_scalar_dense"}


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for sub in x for t in _tensors(sub)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class ShardCostMode(TorchDispatchMode):
    """Per-rank costs of what runs under it, counted on local shards.

    The step runs on fake tensors of ``fake_mode``; only ops on those
    count.  An op with a DTensor operand is passed on to DTensor's
    dispatch, so the mode sees the local ops DTensor issues for this
    rank, and plain ops as they are.  It counts

    * ``flops``: ``flop_registry``'s count of every matmul-type op (the
      formulas ``FlopCounterMode`` uses; elementwise ops count none);
    * ``bytes``: each op's tensor operands and results, read once and
      written once (view and metadata ops move none), the counterpart of
      XLA's "bytes accessed" without its fusion;
    * the live bytes of every storage an op creates, freed when the
      storage is (``peak_temp`` the most at once); storages of
      :meth:`exclude`-d tensors (the step's arguments) are not temps;
    * each functional collective: its payload (the larger of its operand
      and result), per kind, and the mesh dim it spans (``group_dims``
      names the process groups).

    Being the dry run's dispatch hook, it also runs DTensor's own
    dispatch with the fake mode unset, and lays a local shard out as its
    DTensor's strides state (:meth:`_match_layout`).
    """

    def __init__(self, fake_mode, group_dims: dict | None = None):
        super().__init__()
        self.fake_mode = fake_mode
        self.group_dims = dict(group_dims or {})
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak_temp = 0
        self.coll_bytes = {k: 0 for k in COLLECTIVES}
        self.coll_counts = {k: 0 for k in COLLECTIVES}
        self.coll_dims: dict = {}
        self._seen: set = set()
        self._known: set = set()
        self._lock = threading.Lock()
        self._in_dtensor = False

    @staticmethod
    def groups_of(mesh) -> dict:
        """{process group name: mesh dim name} of a DeviceMesh."""
        return {mesh.get_group(i).group_name: name
                for i, name in enumerate(mesh.mesh_dim_names)}

    def exclude(self, tensors) -> None:
        """Storages that are the step's arguments, not temps (a DTensor's
        local shard)."""
        for t in tensors:
            if isinstance(t, DTensor):
                t = t.to_local()
            self._known.add(t.untyped_storage()._cdata)

    def _free(self, key, n) -> None:
        with self._lock:
            self.live -= n
            self._seen.discard(key)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._known or key in self._seen:
            return
        n = st.nbytes()
        with self._lock:
            self._seen.add(key)
            self.live += n
            self.peak_temp = max(self.peak_temp, self.live)
        weakref.finalize(st, self._free, key, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            if self._in_dtensor:
                return NotImplemented
            # DTensor's sharding rules compute small index tensors of
            # their own, which a fake mode cannot read back: its dispatch
            # runs with the fake mode unset (and this mode back on, to see
            # the local ops, which run on fake shards all the same)
            self._in_dtensor = True
            try:
                with unset_fake_temporarily(), self:
                    out = func(*args, **kwargs)
            finally:
                self._in_dtensor = False
            for t in _tensors(out):
                if isinstance(t, DTensor):
                    self._match_layout(t)
            return out
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if not any(isinstance(t, FakeTensor) and t.fake_mode is self.fake_mode
                   for t in outs + _tensors(args)):
            # DTensor's own bookkeeping (index tensors, and the global-shape
            # trace of each new op under a fake mode of its own)
            return out
        name = func._overloadpacket.__name__
        kind = _KIND.get(name) if func.namespace in (
            "_c10d_functional", "_dtensor") else None
        if kind is not None:
            payload = max(sum(_nbytes(t) for t in _tensors(args)),
                          sum(_nbytes(t) for t in outs))
            self.coll_bytes[kind] += payload
            self.coll_counts[kind] += 1
            group = args[-1] if isinstance(args[-1], str) else \
                kwargs.get("group_name")
            dim = self.group_dims.get(group, str(group))
            by_kind = self.coll_dims.setdefault(kind, {})
            by_kind[dim] = by_kind.get(dim, 0) + 1
        elif func._overloadpacket in flop_registry:
            self.flops += flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out)
        if kind is None and not func.is_view and name not in _NO_BYTES:
            self.bytes += sum(_nbytes(t) for t in _tensors(args)
                              + _tensors(list(kwargs.values())) + outs)
        for t in outs:
            self._track(t)
        return out

    def _match_layout(self, t: DTensor) -> None:
        """Lay a DTensor's local shard out in the order its strides state.

        A redistribution's backward gives the gradient the incoming
        gradient's strides, while a collective returns a contiguous
        shard: a transposed gradient then holds a contiguous shard its
        strides misstate, and a later view of it fails.  The shard is
        copied into the stated order (a copy counted as any other)."""
        local = t._local_tensor
        if local.ndim < 2 or 0 in t.stride():
            return
        order = sorted(range(t.ndim), key=lambda d: (-t.stride()[d], d))
        big = [d for d in order if local.shape[d] > 1]
        if sorted(big, key=lambda d: -local.stride()[d]) == big:
            return
        with self:
            fixed = local.permute(order).contiguous()
        inv = [order.index(d) for d in range(t.ndim)]
        t._local_tensor = fixed.permute(inv)

    def collective_bytes(self) -> dict:
        """Payload bytes per kind, ``"_counts"`` per kind (the reference's
        ``collective_bytes_from_hlo`` layout) and ``"_mesh_dims"``: per
        kind, the count over each mesh dim."""
        out = dict(self.coll_bytes)
        out["_counts"] = dict(self.coll_counts)
        out["_mesh_dims"] = {k: dict(v) for k, v in self.coll_dims.items()}
        return out


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
