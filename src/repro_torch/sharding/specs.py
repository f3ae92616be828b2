"""Sharding rule tables for every architecture family (the port of
``repro/sharding/specs.py``).

Strategy (single pod, mesh ("data", "model")):

  * tensor parallelism over ``model``: attention heads / FFN hidden /
    expert (or expert-hidden) dims;
  * FSDP over ``data`` (+ ``pod`` when present): the *other* large dim of
    each weight is sharded over the data axes, so Grok-314B's
    parameters and optimizer state fit per rank; the dry run gathers
    each layer's weights over the data axes where the layer runs
    (``activations.constrain_params``), as XLA's per-layer all-gathers
    do in the reference;
  * batch over the data axes (and pod).

For the ODCL one-shot mode parameters instead carry a leading client
axis sharded over ``data`` (clients must NOT share parameters) and FSDP
moves to the remaining axes.

A spec is a tuple with one entry per tensor dim, as the reference's
``PartitionSpec``: None (replicated), a mesh axis name, or a tuple of
names (the dim split over their product, row-major).  :func:`placements`
turns one into DTensor placements over a mesh.  Rules are *name-based*:
each parameter path is matched to a (tp_dim, fsdp_dim) pair, one table
for all ten architectures.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import axis_sizes


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Axis names of the mesh roles (None disables that role)."""
    data_axes: tuple = ("data",)        # batch / FSDP axes ("pod","data") multi-pod
    model_axis: Optional[str] = "model"
    fsdp: bool = True                   # shard params over data axes too
    client_axis: Optional[str] = None   # ODCL mode: leading client dim

    @property
    def fsdp_axes(self):
        return self.data_axes if self.fsdp else ()


# (tp_dim, fsdp_dim) per parameter leaf, counted from the END of the
# shape (negative), ignoring any leading layer-stack axis. None = skip.
_RULES: list[tuple[str, tuple[Optional[int], Optional[int]]]] = [
    # attention projections: shard head dim over model, d_model over data
    ("attn/wq", (-1, -2)),
    ("attn/wk", (-1, -2)),
    ("attn/wv", (-1, -2)),
    ("attn/wo", (-2, -1)),
    ("attn/bq", (-1, None)),
    ("attn/bk", (-1, None)),
    ("attn/bv", (-1, None)),
    # dense MLP: hidden over model
    ("mlp/w_in", (-1, -2)),
    ("mlp/w_out", (-2, -1)),
    # MoE: router replicated-ish; experts sharded (see param_specs)
    ("moe/router", (-1, None)),
    ("moe/shared/w_in", (-1, -2)),
    ("moe/shared/w_out", (-2, -1)),
    # xLSTM
    ("m/w_up", (-1, -2)),
    ("m/w_q", (-1, -2)),
    ("m/w_k", (-1, -2)),
    ("m/w_v", (-1, -2)),
    ("m/w_if", (None, -2)),
    ("m/w_down", (-2, -1)),
    ("s/w_zifo", (-1, -2)),
    ("s/w_out", (-2, -1)),
    # hybrid SSM branch: inner dim over model
    ("ssm/w_in", (-1, -2)),
    ("ssm/w_xdb", (None, -2)),
    ("ssm/w_dt", (-1, None)),
    ("ssm/a_log", (-2, None)),
    ("ssm/d_skip", (-1, None)),
    ("ssm/w_out", (-2, -1)),
    ("ssm/conv_w", (-1, None)),
    # embeddings / head: vocab over model, d_model over data
    ("embed", (-2, -1)),
    ("lm_head", (-1, -2)),
    ("frontend_proj", (-1, -2)),
    ("patch_proj", (-1, -2)),
]


def _divides(n: int, mesh_axis_size: int) -> bool:
    return mesh_axis_size > 0 and n % mesh_axis_size == 0


def _leaf_spec(path_s, leaf, cfg, rules: ShardingRules, mesh_sizes,
               stacked: bool) -> tuple:
    ndim = leaf.ndim
    entries = [None] * ndim
    if rules.client_axis is not None:
        entries[0] = rules.client_axis

    tp_dim = fsdp_dim = None
    matched = False
    for pat, (tp, fs) in _RULES:
        if path_s.endswith(pat):
            tp_dim, fsdp_dim = tp, fs
            matched = True
            break

    # MoE expert tensors: special-case expert sharding
    if "moe/w_in" in path_s or "moe/w_out" in path_s:
        # shape (..., E, D, F) or (..., E, F, D)
        e_size = leaf.shape[-3]
        m_ax = rules.model_axis
        msize = mesh_sizes.get(m_ax, 1) if m_ax else 1
        if _divides(e_size, msize):
            entries[-3] = m_ax                         # expert parallel
            fsdp_dim = -2 if path_s.endswith("w_in") else -1
        else:
            # hidden-dim tensor parallel inside each expert
            tp_target = -1 if path_s.endswith("w_in") else -2
            entries[tp_target] = m_ax
            fsdp_dim = -2 if path_s.endswith("w_in") else -1
        entries = _apply_fsdp(entries, leaf, fsdp_dim, rules, mesh_sizes)
        return tuple(entries)

    if not matched:
        return tuple(entries)

    m_ax = rules.model_axis
    if tp_dim is not None and -tp_dim > ndim:
        tp_dim = None      # pattern matched a lower-rank leaf (e.g. bias)
    if fsdp_dim is not None and -fsdp_dim > ndim:
        fsdp_dim = None
    if tp_dim is not None and m_ax is not None:
        msize = mesh_sizes.get(m_ax, 1)
        if _divides(leaf.shape[tp_dim], msize) and entries[tp_dim] is None:
            entries[tp_dim] = m_ax
    alt = tp_dim if (tp_dim is not None and entries[tp_dim] is None) else None
    entries = _apply_fsdp(entries, leaf, fsdp_dim, rules, mesh_sizes,
                          alt_dim=alt)
    return tuple(entries)


def _apply_fsdp(entries, leaf, fsdp_dim, rules: ShardingRules, mesh_sizes,
                alt_dim=None):
    """Shard one dim over the FSDP axes; falls back to ``alt_dim`` and to
    axis subsets when the preferred dim is not divisible (e.g. hymba's
    d_model=1600 does not divide 256 but its d_ff=5504 divides 16)."""
    if fsdp_dim is None or not rules.fsdp_axes:
        return entries
    full = tuple(rules.fsdp_axes)
    candidates = []
    for ax in (full,) + tuple((a,) for a in full if len(full) > 1):
        size = 1
        for a in ax:
            size *= mesh_sizes.get(a, 1)
        for dim in (fsdp_dim, alt_dim):
            if dim is None:
                continue
            candidates.append((dim, ax, size))
    for dim, ax, size in candidates:
        if size <= 1:
            continue
        if entries[dim] is None and leaf.shape[dim] % size == 0:
            entries[dim] = ax if len(ax) > 1 else ax[0]
            return entries
    return entries


def _map_with_path(fn, tree, prefix: str = ""):
    """``tree_map`` whose ``fn`` also gets the leaf's "/"-joined path."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, tree[k],
                                  f"{prefix}/{k}" if prefix else str(k))
                for k in sorted(tree)}
    if isinstance(tree, list):
        return [_map_with_path(fn, t, prefix) for t in tree]
    return fn(prefix, tree)


def param_specs(cfg: ModelConfig, params_shape, rules: ShardingRules, mesh):
    """A spec tree mirroring the parameter tree (the reference's layout:
    every layer weight stacked on a leading L axis under "layers").

    ``params_shape`` -- the tree of (meta) tensors from
    ``abstract_params``; if rules.client_axis is set every leaf carries
    a prepended client dim.
    """
    mesh_sizes = axis_sizes(mesh)

    def one(path, leaf):
        return _leaf_spec(path, leaf, cfg, rules, mesh_sizes,
                          path.startswith("layers"))

    return _map_with_path(one, params_shape)


def batch_spec(cfg: ModelConfig, rules: ShardingRules, mesh=None):
    """Input batch sharding: leading (client?, batch) over the data axes.

    The batch dim is left unsharded when it does not divide the data
    axes (e.g. long_500k's global_batch=1).
    """
    data = tuple(rules.data_axes)
    data_entry = (data if len(data) > 1 else data[0]) if data else None
    dsize = 1
    if mesh is not None:
        sizes = axis_sizes(mesh)
        for a in data:
            dsize *= sizes.get(a, 1)

    def spec_for(leaf) -> tuple:
        ndim = getattr(leaf, "ndim", None)
        shape = getattr(leaf, "shape", None)
        if ndim is None:  # an int ndim was passed
            ndim, shape = leaf, None
        entries = [None] * ndim
        idx = 0
        if rules.client_axis is not None:
            entries[0] = rules.client_axis
            idx = 1
        if data_entry is not None and ndim > idx and (
                shape is None or dsize <= 1 or shape[idx] % dsize == 0):
            entries[idx] = data_entry
        return tuple(entries)

    return spec_for


def cache_specs(cfg: ModelConfig, cache_shape, rules: ShardingRules, mesh):
    """Decode-cache sharding: batch over data axes, heads/state over model.

    ``cache_shape`` is the port's ``DecodeCache``: a list of per-layer
    dicts and a Python-int ``pos``.  The specs are the reference's with
    its leading layer axis dropped (``pos`` gets ``()``).  Ring capacity
    is sharded only under ``splitk_decode``.
    """
    mesh_sizes = axis_sizes(mesh)
    data = tuple(rules.data_axes)
    data_entry = data if len(data) > 1 else data[0]
    dsize = 1
    for a in data:
        dsize *= mesh_sizes.get(a, 1)
    msize = mesh_sizes.get(rules.model_axis, 1) if rules.model_axis else 1

    def one(name, leaf) -> tuple:
        entries = [None] * leaf.ndim
        bdim = 0
        if leaf.ndim > bdim and leaf.shape[bdim] % dsize == 0:
            entries[bdim] = data_entry
        if name in ("k", "v"):
            # ring buffers (b, hkv, cap, dh)
            if getattr(cfg, "splitk_decode", False):
                # split-K serving: shard the LENGTH dim (the write is an
                # elementwise select, so no shard holds a partial slot)
                if leaf.ndim > bdim + 2 and leaf.shape[bdim + 2] % msize == 0 \
                        and msize > 1:
                    entries[bdim + 2] = rules.model_axis
                return tuple(entries)
            # default: only the heads dim may shard -- a sharded capacity
            # dim would put the per-token slot write at an unknown shard
            if leaf.ndim > bdim + 1 and leaf.shape[bdim + 1] % msize == 0 \
                    and msize > 1:
                entries[bdim + 1] = rules.model_axis
            return tuple(entries)
        # recurrent states are replaced wholesale each step: shard the
        # first big divisible axis over model
        for dim in range(bdim + 1, leaf.ndim):
            if msize > 1 and leaf.shape[dim] % msize == 0 \
                    and leaf.shape[dim] >= msize:
                entries[dim] = rules.model_axis
                break
        return tuple(entries)

    layers = [{name: one(name, leaf) for name, leaf in sorted(lay.items())}
              for lay in cache_shape.layers]
    return type(cache_shape)(layers=layers, pos=())


def opt_state_specs(param_spec_tree):
    """AdamW moments mirror the parameter specs; step is replicated."""
    return {
        "mu": param_spec_tree,
        "nu": param_spec_tree,
        "step": (),
    }


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements over ``mesh`` for one spec: ``Shard(d)`` on every
    mesh dim that dim d's entry names (a tuple entry shards d over each
    named mesh dim, in mesh order, which is row-major), ``Replicate``
    elsewhere."""
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def spec_map(fn, specs, *trees):
    """``fn(spec, *leaves)`` over a spec tree (dicts and lists whose
    leaves are spec tuples) and trees of the same structure."""
    if isinstance(specs, dict):
        return {k: spec_map(fn, specs[k], *(t[k] for t in trees))
                for k in specs}
    if isinstance(specs, list):
        return [spec_map(fn, s, *(t[i] for t in trees))
                for i, s in enumerate(specs)]
    return fn(specs, *trees)
