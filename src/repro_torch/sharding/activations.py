"""Activation sharding constraints (logical-role based), the port of
``repro/sharding/activations.py``.

Model code calls ``constrain(x, role_0, role_1, ...)`` with one logical
role per axis: 'batch', 'heads', 'model', 'vocab', 'experts' or None.
Outside an ``activation_sharding`` context every function here returns
its input unchanged (every single-device run, and every CPU parity
test); inside (the dry run) ``constrain`` redistributes a DTensor to the
mesh-resolved placements -- skipping any role whose axis size does not
divide the mesh axis, so the same model code traces on every mesh --
as the reference's ``with_sharding_constraint`` pins XLA's layout.

The rest covers what XLA's SPMD partitioner does on its own and DTensor
does not:

* :func:`constrain_params` gathers a layer's weights over the data
  (FSDP) axes where the layer runs, the per-layer all-gather of the
  reference's FSDP; its backward reduce-scatters the gradients;
* :func:`model_divides` says whether a head count splits over the model
  axis (a reshape to heads cannot split a dim sharded unevenly);
* :func:`embedding` (rows of a table) and :func:`gather_last` (one
  entry of the last dim a row) work on a vocab-sharded operand shard by
  shard, and :func:`logsumexp_last` reduces a vocab-sharded dim, where
  DTensor would refuse or gather the dim whole;
* :func:`chunk_last` splits a sharded last dim by an all-to-all, and
  :func:`hold_layout` keeps a gradient at its tensor's placements;
* :func:`per_shard` runs a pointwise op shard by shard,
  :func:`batch_local` an op whose rows are independent on each rank's
  batch rows, and :func:`heads_local` attention on each rank's rows and
  heads (``local_map``): for ops DTensor has no sharding rule for, or
  none that avoids a gather.

The context is a module global, not thread-local as the reference's: the
autograd engine runs a CUDA backward, and with it a rematerialised
layer's forward, on its own device thread.
"""
from __future__ import annotations

import contextlib
import dataclasses
from types import SimpleNamespace
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import (
    implicit_replication,
    local_map,
)

from repro_torch.sharding.specs import placements

_CTX: list = []


@dataclasses.dataclass(frozen=True)
class ActivationCtx:
    mesh: object
    data_axes: tuple        # axes carrying batch (and FSDP)
    model_axis: Optional[str]
    sizes: dict

    @property
    def data_size(self) -> int:
        n = 1
        for a in self.data_axes:
            n *= self.sizes.get(a, 1)
        return n

    @property
    def model_size(self) -> int:
        return self.sizes.get(self.model_axis, 1) if self.model_axis else 1


@contextlib.contextmanager
def activation_sharding(mesh, data_axes: tuple, model_axis: Optional[str]):
    """Inside: the roles resolve against ``mesh``, and plain tensors met
    beside DTensors (positions, masks, constants) count as replicated."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    _CTX.append(ActivationCtx(mesh=mesh, data_axes=tuple(data_axes),
                              model_axis=model_axis, sizes=sizes))
    try:
        with implicit_replication():
            yield
    finally:
        _CTX.pop()


def current_ctx() -> Optional[ActivationCtx]:
    return _CTX[-1] if _CTX else None


def constrain(x, *roles):
    ctx = current_ctx()
    if ctx is None or not isinstance(x, DTensor):
        return x
    assert len(roles) == x.ndim, (roles, x.shape)
    entries = []
    dsize, msize = ctx.data_size, ctx.model_size
    model_used = False
    for dim, role in enumerate(roles):
        if role == "batch" and x.shape[dim] % dsize == 0 and dsize > 1:
            entries.append(ctx.data_axes if len(ctx.data_axes) > 1
                           else ctx.data_axes[0])
        elif role in ("heads", "model", "vocab", "experts") and \
                ctx.model_axis and not model_used and \
                x.shape[dim] % msize == 0 and msize > 1:
            entries.append(ctx.model_axis)
            model_used = True
        else:
            entries.append(None)
    target = placements(tuple(entries), ctx.mesh)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(ctx.mesh, target)


def model_divides(n: int) -> bool:
    """Whether ``n`` heads split evenly over the model axis (True outside
    the context)."""
    ctx = current_ctx()
    return ctx is None or n % ctx.model_size == 0


def constrain_params(tree):
    """A layer's weights (a tensor or a namespace of them) gathered over
    the data axes, their model-axis sharding kept."""
    ctx = current_ctx()
    if ctx is None:
        return tree
    if isinstance(tree, SimpleNamespace):
        return SimpleNamespace(**{k: constrain_params(v)
                                  for k, v in vars(tree).items()})
    if not isinstance(tree, DTensor):
        return tree
    pl = tuple(Replicate() if name in ctx.data_axes else p
               for name, p in zip(ctx.mesh.mesh_dim_names, tree.placements))
    return tree.redistribute(ctx.mesh, pl)


def hold_layout(x):
    """``x`` as it is, with its gradient brought back to ``x``'s
    placements (a matmul's backward may return it sharded where the view
    that made ``x`` cannot split it back)."""
    if current_ctx() is None or not isinstance(x, DTensor):
        return x
    pl = list(x.placements)
    return local_map(lambda t: t, out_placements=pl, in_placements=(pl,),
                     device_mesh=x.device_mesh)(x)


def chunk_last(x, n: int) -> tuple:
    """``torch.chunk(x, n, dim=-1)``.  Inside the context, where the last
    dim is sharded, the shards first move to another dim (an all-to-all:
    DTensor would gather the chunked dim whole), the pieces are cut
    locally and move back, so each keeps ``x``'s placements; ``x``'s
    gradient is held at them, so the products on either side stay
    sharded."""
    if current_ctx() is None or not isinstance(x, DTensor):
        return torch.chunk(x, n, dim=-1)
    mesh, last = x.device_mesh, x.ndim - 1
    pl = [Replicate() if p.is_partial() else p for p in x.placements]
    x = hold_layout(x.redistribute(mesh, pl))
    moved = list(pl)
    for i, p in enumerate(pl):
        if p == Shard(last):
            free = [d for d in range(last)
                    if Shard(d) not in moved
                    and x.shape[d] % mesh.size(i) == 0]
            moved[i] = (Shard(max(free, key=lambda d: x.shape[d]))
                        if free else Replicate())
    if moved != pl:
        x = x.redistribute(mesh, moved)
    return tuple(c.redistribute(mesh, pl)
                 for c in torch.chunk(x, n, dim=-1))


def _reduced(x):
    """A partial sum reduced where the graph can see it: the reduction's
    backward keeps the gradient replicated (reduced inside a later op's
    dispatch, the gradient would come back partial, and a partial
    gradient met by a sharded operand is gathered whole)."""
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements])


def logsumexp_last(x):
    """``torch.logsumexp(x, dim=-1)``; inside the context, with the last
    dim sharded, as max + log(sum(exp(x - max))): reductions DTensor
    keeps partial over a sharded dim (rather than gathering it whole)."""
    if current_ctx() is None or not isinstance(x, DTensor) \
            or Shard(x.ndim - 1) not in x.placements:
        return torch.logsumexp(x, dim=-1)
    m = torch.amax(x, dim=-1, keepdim=True).detach()
    total = _reduced(torch.sum(torch.exp(x - m), dim=-1, keepdim=True))
    return (torch.log(total) + m)[..., 0]


def _vocab_slice(mesh, mdim, n: int):
    """For ``n`` ids sharded over mesh dim ``mdim`` (None: unsharded), a
    function of ids -> (ids within this rank's slice, clamped into it;
    whether each id falls in it)."""
    local_n = n // (mesh.size(mdim) if mdim is not None else 1)
    offset = mesh.get_local_rank(mdim) * local_n if mdim is not None else 0

    def in_slice(ids):
        ids = ids - offset
        return ids.clamp(0, local_n - 1), (ids >= 0) & (ids < local_n)

    return in_slice


def gather_last(x, idx):
    """``x[..., idx]`` row by row: ``take_along_dim(x, idx[..., None],
    -1)[..., 0]``.  On a DTensor whose last dim is sharded over one mesh
    dim, each rank takes the entries that fall in its slice (zero
    elsewhere) and the result is their sum over that dim."""
    ctx = current_ctx()
    vdim = x.ndim - 1
    sharded = ([i for i, p in enumerate(x.placements) if p == Shard(vdim)]
               if ctx is not None and isinstance(x, DTensor) else [])
    if len(sharded) != 1:
        if ctx is not None and isinstance(x, DTensor):
            x = x.redistribute(x.device_mesh, tuple(
                Replicate() if p == Shard(vdim) or p.is_partial() else p
                for p in x.placements))
        return torch.take_along_dim(x, idx[..., None], dim=-1)[..., 0]
    mdim = sharded[0]
    x_pl = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    idx_pl = tuple(Replicate() if i == mdim else p
                   for i, p in enumerate(x_pl))
    out_pl = tuple(Partial() if i == mdim else p
                   for i, p in enumerate(x_pl))
    in_slice = _vocab_slice(x.device_mesh, mdim, x.shape[vdim])

    def local(xl, il):
        il, inside = in_slice(il)
        got = torch.take_along_dim(xl, il[..., None], dim=-1)[..., 0]
        return torch.where(inside, got, torch.zeros((), dtype=got.dtype,
                                                    device=got.device))

    return _reduced(local_map(
        local, out_placements=list(out_pl), in_placements=(x_pl, idx_pl),
        device_mesh=x.device_mesh, redistribute_inputs=True)(x, idx))


def embedding(table, ids):
    """``table[ids]``: rows of a (V, D) table.  Inside the context each
    rank looks up the ids that fall in its slice of a vocab-sharded table
    (zero rows for the others), and the ranks' rows are summed over that
    mesh dim; the table's D dim is gathered first, and the result's
    leading dims follow the ids' placements."""
    ctx = current_ctx()
    if ctx is None or not isinstance(table, DTensor):
        return table[ids]
    mesh = table.device_mesh
    vocab = [i for i, p in enumerate(table.placements) if p == Shard(0)]
    if len(vocab) > 1:
        vocab = []
    t_pl = tuple(Shard(0) if i in vocab else Replicate()
                 for i in range(mesh.ndim))
    ids_pl = tuple(Replicate() if i in vocab or not p.is_shard() else p
                   for i, p in enumerate(ids.placements)) \
        if isinstance(ids, DTensor) else tuple(Replicate() for _ in t_pl)
    out_pl = tuple(Partial() if i in vocab else p
                   for i, p in enumerate(ids_pl))
    in_slice = _vocab_slice(mesh, vocab[0] if vocab else None,
                            table.shape[0])

    def local(tl, il):
        il, inside = in_slice(il)
        rows = tl[il]
        return rows * inside[..., None].to(rows.dtype)

    return _reduced(local_map(
        local, out_placements=list(out_pl), in_placements=(t_pl, ids_pl),
        device_mesh=mesh, redistribute_inputs=True)(table, ids))


def per_shard(fn, x):
    """``fn(x)`` for a pointwise ``fn``, shard by shard (a partial sum is
    reduced first)."""
    if current_ctx() is None or not isinstance(x, DTensor):
        return fn(x)
    pl = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    return local_map(fn, out_placements=list(pl), in_placements=(pl,),
                     device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x)


def _rows_placements(ctx, x) -> tuple:
    """Dim 0 over the data axes (when it divides them), replicated
    elsewhere."""
    shard = x.shape[0] % ctx.data_size == 0 and ctx.data_size > 1
    return tuple(Shard(0) if (shard and name in ctx.data_axes)
                 else Replicate() for name in ctx.mesh.mesh_dim_names)


def heads_local(fn, *args):
    """``fn(*args)`` for an ``fn`` independent over dims 0 and 1 of its
    (b, h, ...) arguments and its result -- attention over each (row,
    head) -- run on each rank's rows and heads: dim 0 over the data axes
    and dim 1 over the model axis, each where it divides (a matmul over
    (b, h, ...) would flatten two sharded dims, which DTensor refuses)."""
    ctx = current_ctx()
    x = args[0]
    if ctx is None or not isinstance(x, DTensor):
        return fn(*args)
    pl = list(_rows_placements(ctx, x))
    if ctx.model_axis and x.shape[1] % ctx.model_size == 0:
        pl[ctx.mesh.mesh_dim_names.index(ctx.model_axis)] = Shard(1)
    return local_map(fn, out_placements=list(pl),
                     in_placements=tuple(pl for _ in args),
                     device_mesh=ctx.mesh, redistribute_inputs=True)(*args)


def batch_local(fn, *args, n_out: int = 1, summed: tuple = ()):
    """``fn(*args)`` for an ``fn`` whose rows (dim 0 of every tensor
    argument and result) are independent, run on each rank's rows; it
    returns ``n_out`` tensors (a tuple when more than one).  The results
    named by index in ``summed`` are sums over the rows instead: partial
    sums over the data axes.  Non-DTensor arguments pass as they are."""
    ctx = current_ctx()
    dts = [a for a in args if isinstance(a, DTensor)]
    if ctx is None or not dts:
        return fn(*args)
    rows = _rows_placements(ctx, dts[0])
    partial = tuple(Partial() if p.is_shard() else p for p in rows)
    out_pl = tuple(list(partial if i in summed else rows)
                   for i in range(n_out))
    return local_map(
        fn, out_placements=out_pl if n_out > 1 else out_pl[0],
        in_placements=tuple(rows if isinstance(a, DTensor) else None
                            for a in args),
        device_mesh=ctx.mesh, redistribute_inputs=True)(*args)
