"""The round's client axis on a device mesh (the port of the reference's
``_constrainer`` / ``AggregationSession._constrain``, which put the client
axis of the sketch and parameter buffers on ``NamedSharding(mesh,
P(client_axis))``).

The port is multi-controller: one process a rank, every rank running the
same code.  ``ClientAxis`` is one rank's place on the named mesh
dim: rank r of R holds the contiguous rows ``[r C / R, (r + 1) C / R)``
of a capacity-C buffer (a C that R does not divide is refused, as the
reference refuses it).  ``RowShard`` describes how the rows of one
client-axis matrix are spread over the ranks (``sizes[r]`` rows on rank
r, in rank order): a session's live rows after evictions are uneven, so
every collective takes the sizes, which every rank knows from its
replicated host state.

The round needs four collectives, all here:

  * ``all_reduce``: the sum of per-cluster sums and counts
    (``all_reduce_pack``: several tensors in one collective);
  * ``take_rows``: rows chosen by global index (a seeding's centers), from
    their owners to every rank;
  * ``gather``: a row-sharded matrix in global row order on every rank
    (the labels, a (C,) vector of distances, a column block);
  * ``dtensor`` / ``expand``: the per-client results as ``DTensor``s,
    ``Shard(0)`` on the client dim, built from local rows without a
    collective where the rows already lie in the DTensor's layout.

A round without a mesh runs the same code on ``LocalAxis``: one rank
holding every row, whose collectives are the identity and whose
per-client results are plain tensors (``LocalShard`` is its
``RowShard``).

A federation is placed on the axis by ``place`` (the reference's
``jax.device_put(state, NamedSharding(mesh, P(client_axis)))``, built
from each rank's own rows: ``core.federated.init_federation(mesh=)``
draws no other rank's rows on its card).  Training finds the axis of a
stacked tree from its leaves (``tree_axis``: the mesh dim their
``DTensor``s are ``Shard(0)`` on), walks this rank's clients through
``mine`` (views of the local shards) and gathers the (C,) per-client
losses for the caller (``gather_clients``).

The backend decides once, here, where a collective's buffer lives: gloo
reduces on the host, so a tensor on the card goes through a host copy;
NCCL takes it on the card.  Every all-reduce, gather and broadcast is
counted in bytes (``mesh.all_reduce.bytes``, ``mesh.gather.bytes``,
``mesh.broadcast.bytes``) and timed under the ``mesh.all_reduce`` /
``mesh.gather`` / ``mesh.broadcast`` spans.

Each mesh dim also has a control group: a gloo group over the same
ranks, made the first time a ``ClientAxis`` of that dim is built (every
rank builds it at the same point of the program) and cached.  It carries
what must not pair with a round's collectives: the route server's
ordered log (``broadcast``, from a thread that runs while a round
all-reduces on the dim's own group) and its close (``control_max``).
"""
from __future__ import annotations

import datetime
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch import obs
from repro_torch.utils import tree_leaves, tree_map


# a follower of the route server's log waits on the control group for as
# long as rank 0 serves
CONTROL_TIMEOUT = datetime.timedelta(days=30)
# mesh dim group name -> (the world it was made in, its control group)
_CONTROL: dict = {}


def control_group(mesh, dim: int, group):
    """The gloo group over the ranks of ``group`` (the mesh's ``dim``),
    made on the first call in a world and cached: ``dist.new_group`` is
    collective over the world, so every rank makes one group for each
    slice of the dim, in the same order."""
    world = dist.group.WORLD
    hit = _CONTROL.get(group.group_name)
    if hit is None or hit[0] is not world:
        layout = mesh.mesh.movedim(dim, -1).reshape(
            -1, mesh.mesh.shape[dim]).tolist()
        mine, _ = dist.new_subgroups_by_enumeration(
            layout, timeout=CONTROL_TIMEOUT, backend="gloo")
        hit = _CONTROL[group.group_name] = (world, mine)
    return hit[1]


def wait(works: Sequence, timeout: Optional[float] = None) -> None:
    """Wait for posted collectives.  With ``timeout`` (seconds, for all
    of them) raise ``TimeoutError`` when one has not ended by then; it
    stays posted, and ends when the ranks it waits for join."""
    deadline = None if timeout is None else time.monotonic() + timeout
    for work in works:
        if deadline is None:
            work.wait()
            continue
        # (a zero timedelta would mean no timeout at all)
        left = max(deadline - time.monotonic(), 1e-3)
        try:
            work.wait(datetime.timedelta(seconds=left))
        except RuntimeError as exc:
            if work.is_completed():      # failed, not late
                raise
            raise TimeoutError(f"a collective did not end within "
                               f"{timeout}s: {exc}") from exc


def chunk_sizes(total: int, ranks: int) -> list:
    """Rows of each rank under ``Shard(0)`` of ``total`` rows (the
    ``torch.chunk`` split DTensor uses: ceil(total / ranks) a rank, the
    last ranks short or empty)."""
    per = -(-total // ranks) if total else 0
    return [max(0, min(per, total - r * per)) for r in range(ranks)]


class ClientAxis:
    """One rank's place on the ``client_axis`` dim of a ``DeviceMesh``."""

    def __init__(self, mesh, client_axis: str = "data"):
        names = tuple(mesh.mesh_dim_names or ())
        if client_axis not in names:
            raise ValueError(f"mesh has no dim {client_axis!r} (its dims: "
                             f"{names})")
        self.mesh = mesh
        self.name = client_axis
        self.group = mesh.get_group(client_axis)
        self.rank = mesh.get_local_rank(client_axis)
        self.size = mesh.size(names.index(client_axis))
        self.placements = [Shard(0) if n == client_axis else Replicate()
                           for n in names]
        self.backend = str(dist.get_backend(self.group))
        # gloo's collectives run on host memory
        self.host_staged = self.backend == "gloo"
        # a traced mesh (the dry run's fake group) sends nothing
        self.control = (None if self.backend == "fake" else control_group(
            mesh, names.index(client_axis), self.group))

    # ------------------------------------------------------------ layout

    def owned(self, capacity: int) -> tuple:
        """(lo, hi): the buffer rows this rank holds of a capacity."""
        if capacity % self.size:
            raise ValueError(
                f"capacity {capacity} is not divisible by the {self.size} "
                f"ranks of the mesh dim {self.name!r}")
        per = capacity // self.size
        return self.rank * per, (self.rank + 1) * per

    def shard(self, sizes: Sequence[int]) -> "RowShard":
        return RowShard(self, sizes)

    def even(self, total: int) -> "RowShard":
        """The shard of ``total`` rows held in equal blocks (refused where
        the ranks do not divide it)."""
        lo, hi = self.owned(total)
        return RowShard(self, [hi - lo] * self.size)

    def local_rows(self, leaf, total: int) -> torch.Tensor:
        """This rank's rows of a client-axis leaf: a ``DTensor``'s local
        shard (checked against the equal blocks), or the slice of a
        global tensor every rank holds."""
        lo, hi = self.owned(total)
        if isinstance(leaf, DTensor):
            local = leaf.to_local()
            if local.shape[0] != hi - lo:
                raise ValueError(f"a DTensor shard of {local.shape[0]} rows "
                                 f"where the mesh holds {hi - lo} a rank")
            return local
        return torch.as_tensor(leaf)[lo:hi]

    def mine(self, tree, total: int):
        """This rank's rows of every leaf of a stacked tree of ``total``
        clients (``local_rows``: views of ``DTensor`` shards)."""
        return tree_map(lambda l: self.local_rows(l, total), tree)

    def place(self, tree, total: int):
        """``Shard(0)`` DTensors of a tree whose leaves hold this rank's
        rows of ``total`` clients, on the mesh's device (no row moves
        between ranks)."""
        lo, hi = self.owned(total)

        def wrap(local):
            if local.shape[0] != hi - lo:
                raise ValueError(f"{local.shape[0]} rows where the mesh "
                                 f"holds {hi - lo} a rank")
            return self._wrap(local.to(self.mesh.device_type).contiguous(),
                              total)

        return tree_map(wrap, tree)

    # ------------------------------------------------------- collectives

    def _staged(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.host_staged and t.is_cuda else t

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns ``t``."""
        nbytes = t.numel() * t.element_size()
        obs.count("mesh.all_reduce.bytes", nbytes)
        with obs.span("mesh.all_reduce", bytes=nbytes):
            buf = self._staged(t)
            dist.all_reduce(buf, group=self.group)
            if buf is not t:
                t.copy_(buf)
        return t

    def all_reduce_pack(self, *ts: torch.Tensor) -> tuple:
        """Sum several tensors over the ranks in one collective; returns
        the sums in their shapes."""
        flat = self.all_reduce(torch.cat([t.reshape(-1) for t in ts]))
        return tuple(p.reshape(t.shape) for p, t in zip(
            torch.split(flat, [t.numel() for t in ts]), ts))

    def barrier(self) -> None:
        dist.barrier(group=self.group)

    def broadcast(self, t: torch.Tensor, *, async_op: bool = False):
        """Rank 0's host tensor ``t`` on every rank, in place, over the
        control group; returns ``t``, or with ``async_op`` the posted
        collective's work (``wait``)."""
        nbytes = t.numel() * t.element_size()
        obs.count("mesh.broadcast.bytes", nbytes)
        with obs.span("mesh.broadcast", bytes=nbytes):
            work = dist.broadcast(t, group=self.control, group_src=0,
                                  async_op=async_op)
        return work if async_op else t

    def control_max(self, t: torch.Tensor, *, async_op: bool = False):
        """The elementwise largest of a host tensor over the ranks, in
        place, on the control group; returns ``t``, or with ``async_op``
        the posted collective's work (``wait``)."""
        work = dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.control,
                               async_op=async_op)
        return work if async_op else t

    def gather_clients(self, local: torch.Tensor, total: int) -> torch.Tensor:
        """A per-client (C,) vector (a step's losses, labels) on every
        rank, from this rank's block of ``total`` clients."""
        return self.even(total).gather(local)

    def gather(self, local: torch.Tensor, sizes: Sequence[int]) -> torch.Tensor:
        """The rows of every rank, concatenated in rank order, on every
        rank (``sizes[r]`` rows from rank r; each piece is padded to the
        largest for the collective)."""
        sizes = [int(s) for s in sizes]
        if local.shape[0] != sizes[self.rank]:
            raise ValueError(f"rank {self.rank} holds {local.shape[0]} rows, "
                             f"the shard says {sizes[self.rank]}")
        width = max(sizes)
        pad = local.new_zeros((width,) + tuple(local.shape[1:]))
        pad[:local.shape[0]] = local
        src = self._staged(pad)
        nbytes = src.numel() * src.element_size() * self.size
        obs.count("mesh.gather.bytes", nbytes)
        with obs.span("mesh.gather", bytes=nbytes):
            parts = [torch.empty_like(src) for _ in range(self.size)]
            dist.all_gather(parts, src, group=self.group)
        return torch.cat([p[:n] for p, n in zip(parts, sizes)]).to(
            local.device)

    # ---------------------------------------------------------- DTensors

    def dtensor(self, local: torch.Tensor, sizes: Sequence[int]) -> DTensor:
        """A ``Shard(0)`` DTensor of the rows spread as ``sizes``: built
        from the local rows where they already lie in the chunk layout,
        else gathered and re-cut."""
        total = int(sum(sizes))
        if list(sizes) != chunk_sizes(total, self.size):
            return self.from_full(self.gather(local, sizes))
        return self._wrap(local.contiguous(), total)

    def expand(self, table: torch.Tensor, index: torch.Tensor) -> DTensor:
        """The ``Shard(0)`` DTensor of ``table[index]`` (a replicated table
        of per-cluster rows, a global (n,) index): each rank gathers its
        own chunk's rows, no collective."""
        n = int(index.shape[0])
        chunks = chunk_sizes(n, self.size)
        lo = sum(chunks[:self.rank])
        idx = index[lo:lo + chunks[self.rank]].to(table.device).long()
        return self._wrap(table.index_select(0, idx), n)

    def from_full(self, full: torch.Tensor) -> DTensor:
        """The ``Shard(0)`` DTensor of a tensor every rank holds whole."""
        chunks = chunk_sizes(full.shape[0], self.size)
        lo = sum(chunks[:self.rank])
        return self._wrap(full[lo:lo + chunks[self.rank]].contiguous(),
                          full.shape[0])

    def full(self, t) -> torch.Tensor:
        """The whole tensor on every rank: a ``Shard(0)`` DTensor gathered
        (plain tensors are returned as they are)."""
        if not isinstance(t, DTensor):
            return t
        return self.gather(t.to_local(), chunk_sizes(t.shape[0], self.size))

    def chunk(self, t) -> tuple:
        """``(this rank's rows, global index of the first)`` of a
        ``Shard(0)`` DTensor, or of a tensor every rank holds whole, in
        the DTensor's chunk layout."""
        sizes = chunk_sizes(t.shape[0], self.size)
        lo = sum(sizes[:self.rank])
        if isinstance(t, DTensor):
            return t.to_local(), lo
        return t[lo:lo + sizes[self.rank]], lo

    def _wrap(self, local: torch.Tensor, total: int) -> DTensor:
        shape = (total,) + tuple(local.shape[1:])
        return DTensor.from_local(local, self.mesh, self.placements,
                                  run_check=False, shape=torch.Size(shape),
                                  stride=_contiguous_stride(shape))


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= max(int(n), 1)
    return tuple(reversed(stride))


class RowShard:
    """The rows of one client-axis matrix over the ranks: ``sizes[r]``
    rows on rank r, global rows in rank order.  This rank holds rows
    ``[offset, offset + m)`` of ``total``."""

    def __init__(self, axis: ClientAxis, sizes: Sequence[int]):
        self.axis = axis
        self.sizes = tuple(int(s) for s in sizes)
        if len(self.sizes) != axis.size:
            raise ValueError(f"{len(self.sizes)} sizes for {axis.size} ranks")
        self.offset = sum(self.sizes[:axis.rank])
        self.m = self.sizes[axis.rank]
        self.total = sum(self.sizes)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        return self.axis.all_reduce(t)

    def all_reduce_pack(self, *ts: torch.Tensor) -> tuple:
        return self.axis.all_reduce_pack(*ts)

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        return self.axis.gather(local, self.sizes)

    def local_part(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a replicated (total, ...) tensor."""
        return t[self.offset:self.offset + self.m]

    def take_rows(self, local: torch.Tensor, index: torch.Tensor):
        """Rows ``index`` (global, (n,)) of the sharded matrix whose local
        rows are ``local``, on every rank, in ``index`` order: each owner
        writes its rows into zeros and one all-reduce sums them (a row
        plus zeros is the row, bit for bit)."""
        idx = index.to(local.device).long().reshape(-1) - self.offset
        mine = (idx >= 0) & (idx < self.m)
        out = local.new_zeros((idx.shape[0],) + tuple(local.shape[1:]))
        out[mine] = local[idx[mine]]
        return self.all_reduce(out)

    def select(self, index: torch.Tensor) -> tuple:
        """A global row selection (a minibatch, in draw order) on this
        rank: ``(local indices of the selected rows it owns, in draw
        order; the RowShard of the selection)``."""
        idx = index.long().reshape(-1)
        bounds = torch.as_tensor([0] + list(self.sizes), device=idx.device)
        edges = torch.cumsum(bounds, 0)
        owner = torch.bucketize(idx, edges[1:], right=True)
        sizes = torch.bincount(owner, minlength=self.axis.size).tolist()
        mine = owner == self.axis.rank
        return idx[mine] - self.offset, RowShard(self.axis, sizes)


class LocalAxis:
    """The client axis of a round without a mesh: rank 0 of 1, holding
    every row.  ``ClientAxis``'s interface with identity collectives, and
    plain tensors where a mesh gives ``Shard(0)`` DTensors."""

    mesh = None
    name = None
    backend = None
    size, rank = 1, 0

    def owned(self, capacity: int) -> tuple:
        return 0, capacity

    def shard(self, sizes: Sequence[int]) -> "LocalShard":
        return LocalShard(self, sizes)

    def even(self, total: int) -> "LocalShard":
        return LocalShard(self, [total])

    def local_rows(self, leaf, total: int) -> torch.Tensor:
        return torch.as_tensor(leaf)

    def mine(self, tree, total: int):
        return tree

    def place(self, tree, total: int):
        return tree

    def barrier(self) -> None:
        pass

    def gather_clients(self, local: torch.Tensor, total: int) -> torch.Tensor:
        return local

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def all_reduce_pack(self, *ts: torch.Tensor) -> tuple:
        return ts

    def gather(self, local: torch.Tensor, sizes: Sequence[int]) -> torch.Tensor:
        return local

    def dtensor(self, local: torch.Tensor, sizes: Sequence[int]):
        return local

    def expand(self, table: torch.Tensor, index: torch.Tensor):
        return table.index_select(0, index.to(table.device).long())

    def from_full(self, full: torch.Tensor):
        return full

    def full(self, t) -> torch.Tensor:
        return t

    def chunk(self, t: torch.Tensor) -> tuple:
        return t, 0


class LocalShard(RowShard):
    """``RowShard`` of ``LocalAxis``: every row is this rank's, so a row
    is taken by indexing and a selection is its own local index."""

    def take_rows(self, local: torch.Tensor, index: torch.Tensor):
        return local[index.to(local.device).long().reshape(-1)]

    def select(self, index: torch.Tensor) -> tuple:
        idx = index.long().reshape(-1)
        return idx, LocalShard(self.axis, [idx.shape[0]])


def client_axis_of(mesh, client_axis: Optional[str] = None):
    """``ClientAxis`` of a mesh's ``client_axis`` dim (its only dim where
    none is named), ``LocalAxis`` without a mesh."""
    if mesh is None:
        return LocalAxis()
    if client_axis is None:
        (client_axis,) = mesh.mesh_dim_names
    return ClientAxis(mesh, client_axis)


def shard_of(points: torch.Tensor, shard=None):
    """``shard``, or where there is none the ``LocalShard`` of every row
    of ``points``."""
    return LocalShard(LocalAxis(), [points.shape[0]]) if shard is None \
        else shard


def tree_axis(tree):
    """The client axis a stacked tree lies on, read from its first leaf:
    the ``ClientAxis`` of the mesh dim a ``DTensor`` is ``Shard(0)`` on,
    else ``LocalAxis`` (plain tensors, or a ``DTensor`` whose first dim
    is not sharded, as the dry run's one-client stacks)."""
    leaves = tree_leaves(tree)
    leaf = leaves[0] if leaves else None
    if isinstance(leaf, DTensor) and leaf.device_mesh.mesh_dim_names:
        for name, p in zip(leaf.device_mesh.mesh_dim_names, leaf.placements):
            if p.is_shard(0):
                return ClientAxis(leaf.device_mesh, name)
    return LocalAxis()
