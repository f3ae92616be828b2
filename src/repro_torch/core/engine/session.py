"""AggregationSession: the server side of Algorithm 1 as a long-lived,
mutable service (the port of ``repro/core/engine/session.py``).

  * ``ingest(wave)`` / ``ingest(sketches=...)``: step-1 uploads, wave by
    wave.  Parameter waves are sketched on the device and written into a
    fixed-capacity (capacity, sketch_dim) buffer, with the parameters in
    a stacked buffer beside it.  Buffers are updated in place (the
    reference rebinds functional arrays; here an in-place row write saves
    a capacity-sized copy per wave).  With ``client_ids=`` the wave is
    keyed: a host-side slot table maps client ids to buffer rows, a
    returning client's row is replaced in place, and ``count`` means live
    clients, not uploads.  A ``sketch_transform`` hook (a scenario's
    sketch channel: the DP release, the colluding spoof) rewrites each
    wave's sketch rows before they are written.
  * staleness: a logical clock advances by one per wave and stamps every
    written row; a policy (``engine/staleness.py``: ``none`` | ``max_age``
    | ``exp_decay``) evicts aged rows onto a free list, which new clients
    take before the written rows grow, or fades their weight in the
    per-cluster mean.
  * ``finalize()``: steps 2-4 over the live rows as two programs, the
    clustering (``session.finalize.cluster``) and the per-cluster mean
    (``session.finalize.mean``); ``snapshot`` / ``compute_round`` /
    ``install_round`` split it for callers that ingest meanwhile
    (``serving.RouteServer``).  ``refinalize`` / ``maybe_refinalize``
    replay the last finalize warm-started: Lloyd from the previous
    centers, the convex family from its previous AMA dual (a cold start
    when the client count changed).
  * ``route()``: nearest recovered cluster for a batch of never-seen
    clients, one program and ONE host transfer per batch, which also
    feeds the ``drift`` gauge that ``maybe_refinalize`` triggers on.

Under a mesh (``mesh=`` / ``client_axis=``, ``sharding/clients.py``)
every rank runs the same calls.  Rank r holds rows ``[r C / R,
(r + 1) C / R)`` of the buffers (a capacity the ranks do not divide is
refused); the slot table, the clock and the stamps stay replicated host
state, so every rank knows where every live row is.  ``ingest`` takes
the global wave and keeps and sketches the rows it owns; a snapshot is
this rank's live rows; the finalize clusters and averages them with
all-reduced sums, the labels come back for every client on every rank,
the per-client parameters as ``Shard(0)`` DTensors, the cluster models
and centers replicated, so ``route`` and ``cluster_model`` need no
collective.  A scenario's sketch hook sees the whole wave's rows at the
wave's first row, as without a mesh, and each rank keeps its own.  A
session without a mesh runs the same code on ``LocalAxis``, one rank
holding every row.

``finalize(engine="host")`` runs the registry's unfused path instead:
``odcl.run_clustering`` of the host family (the Lloyd names, ``gradient``,
``convex``, ``clusterpath``; an explicit ``"<name>-device"`` downgrades
to its host base) over the snapshot's sketches, on the session's device,
then the per-cluster reduction and a fresh AdamW state for every client.

Every wait is local to the calling thread's current stream, so a round
computed on a worker's stream does not stall routes and ingests on
other threads.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.clustering.api import (
    device_twin,
    get_algorithm,
    is_device_algorithm,
    meta_to_host,
    resolve_device_request,
    resolve_host_request,
)
from repro_torch.core.engine.aggregate import (
    _cluster_program,
    _gather_rows_program,
    _mean_program,
    _route_program,
    _warm_cluster_program,
    compact_labels,
    materialize_round,
)
from repro_torch.core.engine.aggregators import get_aggregator
from repro_torch.core.engine.device_kmeans import direct_inertia
from repro_torch.core.engine.staleness import make_staleness_policy
from repro_torch.core.federated import FederatedState, _leaf_filter_for
from repro_torch.core.sketch import (
    SKETCH_BLOCK,
    jl_projection,
    make_generator,
    sketch_leaves,
    sketch_stacked,
    sketch_tree,
)
from repro_torch.core.odcl import run_clustering
from repro_torch.device import resolve_device
from repro_torch.optim import adamw_init
from repro_torch.sharding.clients import client_axis_of
from repro_torch.utils import tree_leaves, tree_map


class SessionSnapshot(NamedTuple):
    """The live rows at one logical clock tick, copied out of the
    session's buffers (which later waves overwrite in place).  A round
    computed from it equals a sequential replay that finalizes right
    after the ``clock``-th wave."""
    sketches: torch.Tensor         # (count, sketch_dim), live rows only
    params: Optional[dict]         # stacked live-params tree or None
    weights: Optional[np.ndarray]  # staleness weights (live-row order) or None
    count: int                     # live clients at snapshot time
    clock: int                     # session clock at snapshot time
    shard: Optional[object] = None  # the rows' RowShard over the ranks


class ServedRound(NamedTuple):
    """What the serving paths read, published by one attribute write."""
    out: tuple                     # (state | None, labels, info)
    centers: torch.Tensor          # (K', sketch_dim) active centers
    first_idx: np.ndarray          # (K',) one member index per cluster
    n_clusters: int
    finalized_d2: float            # mean row d^2 at finalize (drift anchor)
    finalized_scale: float         # mean row scale (degenerate fallback)
    clock: int                     # snapshot clock this round was built from
    count: int                     # snapshot live-client count
    models: Optional[dict] = None  # (K', ...) cluster models (params only)


def _structure(tree):
    if isinstance(tree, dict):
        return tuple((key, _structure(tree[key])) for key in sorted(tree))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(_structure(t) for t in tree))
    return "leaf"


class AggregationSession:
    """Streaming, mutable server-side aggregation over a fixed capacity.

    Args:
      capacity: maximum number of live clients (evicted rows are reused).
      sketch_dim: JL sketch width.
      seed / cluster_seed: seed the JL projection and the clustering's
        generator (a fresh generator per finalize, as the reference
        builds a fresh key).
      staleness: a policy from ``engine/staleness.py`` or its spelling
        (``"none"`` | ``"max_age=3"`` | ``"exp_decay=2.0"``).
      projection: an explicit (n, sketch_dim) projection in place of the
        one drawn from ``seed`` (how tests carry the reference's across).
        Without one, S is cached whole for clients of up to 65 536 values
        and streamed block by block past that.
      sketch_transform: an optional ``(sketches, offset) -> sketches``
        hook applied to every wave's (w, sketch_dim) rows before they are
        written (the scenarios' sketch channel: the DP release, the
        colluding spoof).  ``offset`` is the wave's first target row plus
        ``row_base``.
      row_base: the global index of this session's row 0, added to the
        hook's offset (a shard of ``HierarchicalSession`` starts at its
        first global client, so a hook keyed by client index sees the
        index the flat session would).
      cfg: the clients' ``ModelConfig``, if any: an MoE model is sketched
        on its router-invariant leaves, as in the reference.
      mesh / client_axis: shard the client axis of the buffers over the
        ``client_axis`` dim of a ``DeviceMesh`` (see the module docstring).
      device: where the buffers live; CUDA unless ``"cpu"`` is asked for.
    """

    def __init__(self, capacity: int, *, sketch_dim: int = 256,
                 seed: int = 0, cluster_seed: Optional[int] = None,
                 staleness="none", projection=None, sketch_transform=None,
                 row_base: int = 0, cfg=None, mesh=None,
                 client_axis: str = "data", device=None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.device = resolve_device(device)
        self.capacity = int(capacity)
        self.sketch_dim = int(sketch_dim)
        self.seed = int(seed)
        self.cluster_seed = self.seed if cluster_seed is None else int(
            cluster_seed)
        self.staleness = make_staleness_policy(staleness)
        self._sketch_transform = sketch_transform
        self.row_base = int(row_base)
        self._projection = (None if projection is None else
                            torch.as_tensor(projection).to(self.device,
                                                           torch.float32))
        self._leaf_filter = _leaf_filter_for(cfg)
        self.mesh, self.client_axis = mesh, client_axis
        self._axis = client_axis_of(mesh, client_axis)
        # the buffer rows this rank holds: [lo, hi) of the capacity
        self._lo, self._hi = self._axis.owned(self.capacity)
        self._sketches = torch.zeros((self._hi - self._lo, self.sketch_dim),
                                     dtype=torch.float32, device=self.device)
        self._params = None            # stacked buffer, allocated lazily
        self._mode: Optional[str] = None    # 'params' | 'sketches'
        # ---- slot table: host-side row bookkeeping -------------------
        self._slots: dict = {}         # client id -> buffer row
        self._row_ids: dict = {}       # buffer row -> client id (keyed only)
        self._live = np.zeros(self.capacity, bool)
        self._stamps = np.zeros(self.capacity, np.int64)
        # live rows per stamp: a policy decides by age, and every row of
        # one stamp has the same age, so eviction and weights ask it
        # about the distinct stamps instead of every row
        self._stamp_counts: dict = {}
        self._free: list = []          # evicted rows, reused from the end
        self._high = 0                 # high-water mark of written rows
        self._count = 0                # LIVE clients (not uploads)
        self._clock = 0                # logical time, +1 per ingested wave
        # ---- finalize / serving state --------------------------------
        self._served: Optional[ServedRound] = None
        self._finalize_kwargs = None   # replayed by refinalize()
        # warm-start cache of the incremental re-finalize
        self._warm_algo_name = None
        self._warm_state = None
        self._warm_count = 0
        # drift: routed traffic's d^2 since the last install
        self._routed_d2_sum = 0.0
        self._routed_n = 0

    # ------------------------------------------------------------ ingest

    @property
    def count(self) -> int:
        """Live clients (re-uploads replace, evictions subtract)."""
        return self._count

    @property
    def clients(self) -> dict:
        """Copy of the live slot table: client id -> buffer row (keyed
        waves only)."""
        return dict(self._slots)

    def _live_rows(self) -> np.ndarray:
        """Sorted buffer rows holding live clients."""
        return np.flatnonzero(self._live[:self._high])

    def _held_live(self) -> tuple:
        """This rank's live rows (indices into its buffers, ``None`` while
        they are a prefix of them) and every rank's count of live rows."""
        if self._count == self._high:     # no holes: a prefix on every rank
            per = self._hi - self._lo
            return None, np.clip(self._high - per * np.arange(
                self._axis.size), 0, per).tolist()
        live = self._live.reshape(self._axis.size, -1)
        rows = np.flatnonzero(live[self._axis.rank])
        prefix = rows.size == 0 or rows[-1] == rows.size - 1
        return (None if prefix else rows), live.sum(axis=1).tolist()

    def _held_rows(self, buf, rows, sizes):
        """The live rows of a buffer (or tree of buffers) this rank
        holds (``_held_live``'s ``rows`` and ``sizes``): a view of the
        prefix, or a gather."""
        if rows is None:
            n = sizes[self._axis.rank]
            return tree_map(lambda l: l[:n], buf)
        idx = torch.as_tensor(rows, device=self.device)
        return tree_map(lambda l: l.index_select(0, idx), buf)

    def _owned(self, rows: np.ndarray) -> tuple:
        """The part of a wave bound for ``rows`` that this rank writes:
        ``(positions in the wave, buffer rows)``."""
        keep = np.flatnonzero((rows >= self._lo) & (rows < self._hi))
        return keep, rows[keep] - self._lo

    def _take(self, tree, keep):
        """The wave rows at ``keep`` (a slice where they are contiguous)."""
        if keep.size and keep[-1] - keep[0] == keep.size - 1:
            lo, hi = int(keep[0]), int(keep[-1]) + 1
            return tree_map(lambda l: l[lo:hi], tree)
        idx = torch.as_tensor(keep, device=self.device)
        return tree_map(lambda l: l.index_select(0, idx), tree)

    @property
    def sketches(self) -> torch.Tensor:
        """Device-resident (count, sketch_dim) live rows: a view while
        they are a contiguous prefix, a gather after evictions.  Under a
        mesh, the live rows this rank holds."""
        return self._held_rows(self._sketches, *self._held_live())

    @property
    def clock(self) -> int:
        """Logical session time, +1 per ingested wave: the key of the
        serialized-replay contract."""
        return self._clock

    def _sync(self) -> None:
        """Wait for the work queued on the calling thread's current
        stream (not the whole device)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _ensure_projection(self, n: int):
        """The projection for clients of n values: the one given, the
        whole S cached for n <= 65 536 (one block), else ``None``: the
        sketch streams S from ``seed``."""
        if self._projection is None:
            if n > SKETCH_BLOCK:
                return None
            self._projection = jl_projection(n, self.sketch_dim,
                                             seed=self.seed,
                                             device=self.device)
        if self._projection.shape != (n, self.sketch_dim):
            raise ValueError(
                f"clients flatten to {n} values but the projection is "
                f"{tuple(self._projection.shape)}")
        return self._projection

    def _width(self, tree, stacked: bool = True) -> int:
        """Values a client contributes to its sketch."""
        return sum((l[0] if stacked else l).numel()
                   for l in sketch_leaves(tree, self._leaf_filter))

    def _sketch_wave(self, wave) -> torch.Tensor:
        """(w, sketch_dim) sketches of a stacked wave, streamed."""
        return sketch_stacked(wave, self._ensure_projection(self._width(wave)),
                              sketch_dim=self.sketch_dim, seed=self.seed,
                              leaf_filter=self._leaf_filter)

    def _to_device(self, tree):
        return tree_map(lambda l: torch.as_tensor(l).to(self.device), tree)

    def _validate_params_wave(self, wave, leaves) -> int:
        """Shape checks BEFORE any bookkeeping changes: a rejected wave
        leaves the session as it was."""
        w = int(leaves[0].shape[0])
        if w < 1:
            raise ValueError("empty wave")
        if any(l.shape[0] != w for l in leaves):
            raise ValueError("parameter wave leaves disagree on the "
                             "leading (client) axis")
        if self._params is not None:
            if _structure(wave) != _structure(self._params):
                raise ValueError("wave tree structure does not match the "
                                 "session's first wave")
            for b, l in zip(tree_leaves(self._params), leaves):
                if tuple(l.shape[1:]) != tuple(b.shape[1:]):
                    raise ValueError(
                        f"wave leaf shape {tuple(l.shape[1:])} does not "
                        f"match the session's {tuple(b.shape[1:])}")
        return w

    def _alloc_rows(self, w: int, client_ids) -> tuple:
        """Map a wave onto buffer rows without changing anything (the
        ``session.ingest.assign`` span).

        Returning ids keep their row; new ids (and anonymous waves) take
        evicted rows from the end of the free list first, then extend the
        written rows.  Returns ``(ids, rows, n_from_free)``, ``ids`` the
        wave's ids as a list (``None`` for an anonymous wave); raises on
        duplicate ids or a full buffer."""
        with obs.span("session.ingest.assign"):
            ids = None
            if client_ids is not None:
                ids = list(client_ids)
                if len(ids) != w:
                    raise ValueError(f"client_ids has {len(ids)} entries "
                                     f"for a wave of {w}")
                if len(set(ids)) != len(ids):
                    raise ValueError("duplicate client ids within one wave")
                rows = np.fromiter((self._slots.get(cid, -1) for cid in ids),
                                   np.int64, w)
            else:
                rows = np.full(w, -1, np.int64)
            new_at = np.flatnonzero(rows < 0)
            n_new = new_at.size
            n_free = len(self._free)
            if n_new > n_free + (self.capacity - self._high):
                raise ValueError(
                    f"session capacity exceeded: {self._count} live + "
                    f"{n_new} new clients > capacity {self.capacity}")
            n_from_free = min(n_new, n_free)
            # the reference pops the free list from its end, one new id at
            # a time
            rows[new_at[:n_from_free]] = self._free[::-1][:n_from_free]
            rows[new_at[n_from_free:]] = np.arange(
                self._high, self._high + n_new - n_from_free)
            return ids, rows, n_from_free

    def _commit_rows(self, rows: np.ndarray, n_from_free: int,
                     ids) -> None:
        """Post-write bookkeeping (the ``session.ingest.commit`` span):
        slot table, free list, stamps, clock; then the staleness policy's
        eviction (``session.evict``, the commit span's sibling)."""
        with obs.span("session.ingest.commit"):
            self._clock += 1
            was_live = self._live[rows]
            self._count += int(np.count_nonzero(~was_live))
            old, n_old = np.unique(self._stamps[rows[was_live]],
                                   return_counts=True)
            for stamp, n in zip(old.tolist(), n_old.tolist()):
                left = self._stamp_counts[stamp] - n
                if left:
                    self._stamp_counts[stamp] = left
                else:
                    del self._stamp_counts[stamp]
            self._stamp_counts[self._clock] = len(rows)
            self._live[rows] = True
            if n_from_free:
                del self._free[len(self._free) - n_from_free:]
            if ids is not None:
                for row, cid in zip(rows.tolist(), ids):
                    self._slots[cid] = row
                    self._row_ids[row] = cid
            self._high = max(self._high, int(rows.max()) + 1)
            self._stamps[rows] = self._clock
        self.evict_stale()

    def _transform(self, sketches: torch.Tensor, rows: np.ndarray,
                   keep: np.ndarray):
        """The sketch hook over this rank's rows (wave positions ``keep``)
        of a wave bound for ``rows``: the hook sees the whole wave's
        (w, sketch_dim) at its first row, as the reference keys keyed
        waves by ``rows[0]``, with zeros in the rows other ranks hold, so
        each row gets the draws it gets without a mesh."""
        if self._sketch_transform is None:
            return sketches
        whole = sketches
        if keep.size != rows.size:
            whole = sketches.new_zeros((rows.size, sketches.shape[1]))
            whole[torch.as_tensor(keep, device=sketches.device)] = sketches
        out = self._sketch_transform(whole, self.row_base + int(rows[0]))
        return out if whole is sketches else self._take(out, keep)

    def _write_rows(self, buf: torch.Tensor, rows: np.ndarray,
                    values: torch.Tensor) -> None:
        start = int(rows[0])
        if np.array_equal(rows, np.arange(start, start + len(rows))):
            buf[start:start + len(rows)] = values
        else:
            buf[torch.as_tensor(rows, device=self.device)] = values

    def ingest(self, wave=None, *, sketches=None, client_ids=None):
        """Ingest one wave of step-1 uploads: a stacked parameter tree (or
        ``FederatedState``) or ``sketches=`` (w, sketch_dim).  With
        ``client_ids=`` (w stable hashable ids) a returning id's row is
        replaced in place and a new id takes a free row.  Returns the row
        assignment for keyed waves, the wave's offset otherwise.

        The ``session.ingest`` span covers the call; its children are
        ``.assign`` (the wave's rows), ``.write`` (the sketch and the row
        writes, ended by a stream synchronize), ``.commit`` (the slot
        table's bookkeeping) and ``session.evict``."""
        if (wave is None) == (sketches is None):
            raise ValueError("pass exactly one of wave= or sketches=")
        with obs.span("session.ingest") as span:
            if sketches is not None:
                return self._ingest_sketches(span, sketches, client_ids)
            return self._ingest_params(span, wave, client_ids)

    def _ingest_params(self, span: dict, wave, client_ids):
        if isinstance(wave, FederatedState):
            wave = wave.params
        if self._mode == "sketches":
            raise ValueError("session already holds sketch-only waves; "
                             "cannot mix in parameter waves")
        if not tree_leaves(wave):
            raise ValueError("empty parameter wave")
        wave = self._to_device(wave)
        leaves = tree_leaves(wave)
        w = self._validate_params_wave(wave, leaves)
        ids, rows, n_from_free = self._alloc_rows(w, client_ids)
        self._ensure_projection(self._width(wave))   # a mismatch raises
        self._mode = "params"      # only after validation
        if self._params is None:
            self._params = tree_map(
                lambda l: torch.zeros(
                    (self._hi - self._lo,) + tuple(l.shape[1:]),
                    dtype=l.dtype, device=self.device),
                wave)
        offset = int(rows[0])
        keep, held = self._owned(rows)
        span.update(wave=w, offset=offset, mode="params")
        with obs.span("session.ingest.write"):
            if held.size:
                part = self._take(wave, keep)
                self._write_rows(self._sketches, held, self._transform(
                    self._sketch_wave(part), rows, keep))
                for buf, l in zip(tree_leaves(self._params),
                                  tree_leaves(part)):
                    self._write_rows(buf, held, l)
            self._sync()
        obs.count("session.ingest.bytes",
                  sum(l.numel() * l.element_size() for l in leaves))
        self._commit_rows(rows, n_from_free, ids)
        return rows if ids is not None else offset

    def _ingest_sketches(self, span: dict, sketches, client_ids):
        if self._mode == "params":
            raise ValueError("session already holds parameter waves; "
                             "cannot mix in sketch-only waves")
        sketches = torch.as_tensor(sketches).to(self.device, torch.float32)
        if sketches.ndim != 2 or sketches.shape[1] != self.sketch_dim:
            raise ValueError(f"sketch wave must be (w, {self.sketch_dim}), "
                             f"got {tuple(sketches.shape)}")
        w = int(sketches.shape[0])
        if w < 1:
            raise ValueError("empty wave")
        ids, rows, n_from_free = self._alloc_rows(w, client_ids)
        self._mode = "sketches"    # only after validation
        offset = int(rows[0])
        keep, held = self._owned(rows)
        span.update(wave=w, offset=offset, mode="sketches")
        with obs.span("session.ingest.write"):
            if held.size:
                self._write_rows(self._sketches, held, self._transform(
                    self._take(sketches, keep), rows, keep))
            self._sync()
        obs.count("session.ingest.bytes",
                  sketches.numel() * sketches.element_size())
        self._commit_rows(rows, n_from_free, ids)
        return rows if ids is not None else offset

    # --------------------------------------------------------- staleness

    def evict_stale(self) -> list:
        """Apply the staleness policy's eviction mask to the live rows:
        evicted rows go to the free list and out of every later finalize.
        Returns the evicted client ids (``None`` for anonymous rows).
        Runs after every ingest and before every finalize, in a
        ``session.evict`` span whose ``evicted`` field counts them."""
        with obs.span("session.evict") as span:
            out = self._evict()
            span["evicted"] = len(out)
        return out

    def _evict(self) -> list:
        if not self._stamp_counts:
            return []
        stamps = np.fromiter(self._stamp_counts, np.int64,
                             len(self._stamp_counts))
        dead = stamps[np.asarray(self.staleness.evict(self._clock - stamps),
                                 bool)]
        if dead.size == 0:
            return []
        rows = self._live_rows()
        evicted = rows[np.isin(self._stamps[rows], dead)]
        for stamp in dead.tolist():
            del self._stamp_counts[stamp]
        out = []
        for row in evicted.tolist():
            cid = self._row_ids.pop(row, None)
            if cid is not None:
                del self._slots[cid]
            out.append(cid)
        self._live[evicted] = False
        self._free.extend(evicted.tolist())
        self._count -= len(out)
        obs.count("session.evictions", len(out))
        return out

    def _live_weights(self):
        """Per-row staleness weights of the live rows, in row order, or
        ``None`` for unweighted policies."""
        stamps = np.fromiter(self._stamp_counts, np.int64,
                             len(self._stamp_counts))
        if self.staleness.weights(self._clock - stamps) is None:
            return None
        return self.staleness.weights(
            self._clock - self._stamps[self._live_rows()])

    # ---------------------------------------------------------- finalize

    def snapshot(self) -> SessionSnapshot:
        """Copy the live rows out at the current clock (a slice's clone
        while they are a contiguous prefix, a gather otherwise), with
        their staleness weights.

        The copy is queued on the calling thread's current stream, after
        every earlier wave of this thread.  Work on that stream reads it
        in order.  A caller that reads it on another stream, or lets a
        later wave overwrite the buffers from another stream, first
        makes that stream wait for this one; callers that ingest from
        several threads also serialize ``ingest`` against ``snapshot``.
        ``serving.RouteServer`` does both."""
        self.evict_stale()
        if self._count == 0:
            raise ValueError("nothing ingested")
        rows, sizes = self._held_live()
        shard = self._axis.shard(sizes)
        if rows is None:              # views of the buffers: copy them out
            sketches, params = tree_map(torch.clone, self._held_rows(
                (self._sketches, self._params), rows, sizes))
        else:
            sketches, params = _gather_rows_program()(
                (self._sketches, self._params),
                torch.as_tensor(rows, device=self.device))
        weights = self._live_weights()
        if weights is not None:
            weights = np.asarray(weights)[shard.offset:shard.offset + shard.m]
        return SessionSnapshot(sketches=sketches, params=params,
                               weights=weights, count=self._count,
                               clock=self._clock, shard=shard)

    def finalize(self, *, algorithm="kmeans-device", k: Optional[int] = None,
                 algo_options: Optional[dict] = None, engine: str = "device",
                 aggregator="mean"):
        """Steps 2-4 over the live rows.  Returns ``(new_state, labels,
        info)`` (``new_state is None`` for sketch-only sessions).
        ``engine``: ``device`` (the fused programs), ``host`` (the
        registry's host families) or ``auto`` (device where the algorithm
        has a device form).  ``aggregator`` names the per-cluster
        parameter reduction (``mean`` | ``trimmed_mean`` | ``median`` |
        ``geometric_median`` | an instance) on both engines.  The
        arguments are remembered: ``refinalize()`` replays them
        warm-started."""
        return self.finalize_snapshot(
            self.snapshot(), algorithm=algorithm, k=k,
            algo_options=algo_options, engine=engine, aggregator=aggregator)

    def refinalize(self):
        """Re-run the last ``finalize`` configuration over the current
        live rows, warm-started from the previous round's state where the
        family supports it (cold otherwise)."""
        if self._finalize_kwargs is None:
            raise ValueError("refinalize() needs a prior finalize()")
        return self.finalize_snapshot(self.snapshot(), warm=True,
                                      **self._finalize_kwargs)

    def maybe_refinalize(self, threshold: float = 1.5):
        """Warm re-finalize when the ``drift`` gauge exceeds
        ``threshold``; ``None`` when it does not (or is unmeasured)."""
        d = self.drift
        if d is None or d <= threshold:
            return None
        obs.count("session.refinalize.triggered")
        return self.refinalize()

    def finalize_snapshot(self, snap: SessionSnapshot, *, warm: bool = False,
                          **kwargs):
        out, served = self.compute_round(snap, warm=warm, **kwargs)
        return self.install_round(out, served)

    def compute_round(self, snap: SessionSnapshot, *, warm: bool = False,
                      algorithm="kmeans-device", k: Optional[int] = None,
                      algo_options: Optional[dict] = None,
                      engine: str = "device", aggregator="mean"):
        """Steps 2-4 over a snapshot without touching the serving state,
        on the calling thread's current stream.  Returns ``(out,
        served)`` for ``install_round``.  The warm-start cache is shared
        state: concurrent calls are serialized by the caller."""
        kwargs = dict(algorithm=algorithm, k=k, algo_options=algo_options,
                      engine=engine, aggregator=aggregator)
        algo, k_eff, algo_options, use_device = self.resolve_round(**kwargs)
        self._adopt(snap)
        with obs.span("session.refinalize" if warm else "session.finalize",
                      count=snap.count,
                      algorithm=getattr(algo, "name", str(algo)),
                      engine="device" if use_device else "host"):
            if use_device:
                out, served = self._finalize_device(
                    algo, k_eff, algo_options, snap, aggregator, warm)
            else:
                out, served = self._finalize_host(
                    algo, k_eff, algo_options, snap, aggregator)
        self._finalize_kwargs = kwargs
        return out, served

    def resolve_round(self, *, algorithm="kmeans-device",
                      k: Optional[int] = None,
                      algo_options: Optional[dict] = None,
                      engine: str = "device", aggregator=None) -> tuple:
        """A round's arguments as ``compute_round`` runs them: ``(algo,
        k or None, algo_options, on the device)``.  Raises ``ValueError``
        for an unknown engine or algorithm and for a missing ``k``, before
        any work: a meshed ``RouteServer`` checks a round here before it
        sends it to the other ranks.  ``aggregator`` is taken and not
        checked (a sketch-only round never reads it)."""
        if engine not in ("auto", "host", "device"):
            raise ValueError(f"engine must be auto|host|device, got "
                             f"{engine!r}")
        if engine == "host":
            # explicit device names downgrade to their host base (or raise
            # for device-only families)
            algorithm, algo_options = resolve_host_request(algorithm,
                                                           algo_options)
        else:
            algorithm, algo_options = resolve_device_request(
                algorithm, algo_options, strict=engine == "device")
        algo = get_algorithm(algorithm)
        dev = algo if is_device_algorithm(algo) else device_twin(algo)
        use_device = engine != "host" and dev is not None
        if use_device:
            algo = dev                   # "convex" runs as "convex-device"
        if algo.requires_k and k is None:
            raise ValueError(f"{getattr(algo, 'name', algo)!r} requires k")
        return algo, (k if algo.requires_k else None), algo_options, \
            use_device

    def _finalize_device(self, algo, k, algo_options, snap, aggregator,
                         warm):
        generator = make_generator(self.cluster_seed, self.device)
        if self._warm_usable(algo, warm, snap.count):
            res = _warm_cluster_program(algo, k, algo_options)(
                generator, snap.sketches, self._warm_state, snap.shard)
            mode = "warm"
        else:
            res = _cluster_program(algo, k, algo_options)(
                generator, snap.sketches, snap.shard)
            mode = "cold"
        self._cache_warm_state(algo, res, snap.count)
        reps = None
        if snap.params is None:
            labels, uniq, first = compact_labels(res.labels)
            info = {"n_clusters": int(len(uniq)),
                    "meta": meta_to_host(res.meta), "engine": "device"}
            out = (None, labels, info)
        else:
            new_params, reps = self._average_params(
                (res.labels, res.centers), snap.params, aggregator,
                snap.weights, snap.shard)
            state = FederatedState(params=snap.params, opt_state=None,
                                   n_clients=snap.count, step=0)
            new_state, labels, info, uniq, first = materialize_round(
                new_params, res, state)
            out = (new_state, labels, info)
        info["count"] = snap.count
        info["refinalize"] = mode if warm else None
        info["snapshot_clock"] = snap.clock
        idx = torch.as_tensor(uniq, dtype=torch.long, device=self.device)
        # the meta inertia of both device families is the direct sum of
        # row d^2 to the assigned centers
        models = (None if reps is None else
                  tree_map(lambda r: r.index_select(0, idx), reps))
        served = self._make_served(out, res.centers[idx].contiguous(),
                                   res.meta["inertia"], first, snap, models)
        return out, served

    def _finalize_host(self, algo, k, algo_options, snap, aggregator):
        """The registry's unfused path on the session's device: the host
        family clusters the snapshot's sketches (``run_clustering``, with
        its Definition-1 margins in the meta), then the per-cluster
        reduction of the parameters and a fresh AdamW state."""
        params, weights = snap.params, snap.weights
        sketches = snap.shard.gather(snap.sketches)  # every row, every rank
        with obs.span("session.finalize.cluster", engine="host"):
            result = run_clustering(
                make_generator(self.cluster_seed, self.device), sketches,
                algo, k=k, **(algo_options or {}))
        labels, _, first = compact_labels(torch.as_tensor(result.labels))
        info = {"n_clusters": result.n_clusters, "meta": result.meta,
                "engine": "host", "count": snap.count,
                "snapshot_clock": snap.clock}
        centers = torch.as_tensor(result.centers, dtype=torch.float32).to(
            self.device)
        labels_t = torch.as_tensor(labels).to(self.device)
        inertia = direct_inertia(sketches, centers, labels_t)
        if params is None:
            out = (None, labels, info)
            return out, self._make_served(out, centers, inertia, first, snap)
        with obs.span("session.finalize.mean", engine="host"):
            new_params, models = self._average_params(
                (labels_t, centers), params, aggregator, weights, snap.shard)
        new_state = FederatedState(
            params=new_params, opt_state=adamw_init(new_params, snap.count),
            n_clients=snap.count, step=0)
        out = (new_state, labels, info)
        models = tree_map(lambda r: r[:len(first)], models)  # compact ids
        return out, self._make_served(out, centers, inertia, first, snap,
                                      models)

    def _adopt(self, snap: SessionSnapshot) -> None:
        """The snapshot was copied on the snapshotting thread's stream and
        is read on this one: record the use, so that its memory is not
        handed to the other stream while this one may still read it."""
        if self.device.type != "cuda":
            return
        stream = torch.cuda.current_stream(self.device)
        for t in [snap.sketches] + tree_leaves(snap.params):
            t.record_stream(stream)

    def install_round(self, out, served: ServedRound):
        """Publish a computed round (one attribute write) and re-anchor
        the drift gauge."""
        self._served = served
        self._routed_d2_sum = 0.0
        self._routed_n = 0
        return out

    def _warm_usable(self, algo, warm: bool, count: int) -> bool:
        if not warm or self._warm_state is None:
            return False
        if getattr(algo, "name", None) != self._warm_algo_name:
            return False
        if not callable(getattr(algo, "device_warm_call", None)):
            return False
        if (getattr(algo, "warm_requires_same_count", False)
                and count != self._warm_count):
            obs.count("session.refinalize.cold_fallback")
            return False
        return True

    def _cache_warm_state(self, algo, res, count: int) -> None:
        if not callable(getattr(algo, "device_warm_call", None)):
            return
        state = algo.warm_state(res)
        if state is not None:
            self._warm_algo_name = getattr(algo, "name", None)
            self._warm_state = state
            self._warm_count = count

    def _average_params(self, clustering, params, aggregator, weights,
                        shard):
        """The mean phase over ``clustering`` = (labels, centers): the
        unweighted program, or the weighted mean where the staleness policy
        supplies decay weights (only for the ``mean`` aggregator, as in
        the reference).  Returns ``(per-client params, cluster models)``:
        the models (K, ...) by raw label, the per-client rows written from
        them (``Shard(0)`` DTensors under a mesh)."""
        labels, centers = clustering
        if weights is not None:
            name = get_aggregator(aggregator).name
            if name != "mean":
                raise ValueError(
                    "staleness weighting (exp_decay) requires the 'mean' "
                    f"aggregator, got {name!r}")
            weights = torch.as_tensor(np.asarray(weights),
                                      dtype=torch.float32, device=self.device)
        return _mean_program(aggregator)(labels, centers, params, shard,
                                         weights)

    def _make_served(self, out, centers, inertia, first, snap,
                     models=None) -> ServedRound:
        """Bundle a round with its drift anchor: the clustering's mean row
        inertia (``inertia``, the direct sum of row d^2 to the assigned
        centers), and the mean row scale as the degenerate fallback (over
        every rank's rows)."""
        sk, shard = snap.sketches, snap.shard
        mean = shard.all_reduce(torch.sum(sk, dim=0, keepdim=True))
        centred = sk - mean / shard.total
        scale = shard.all_reduce(torch.sum(torch.sum(centred * centred,
                                                     dim=1))) / shard.total
        anchors = torch.stack([inertia.to(torch.float32),
                               scale]).cpu().tolist()
        return ServedRound(out=out, centers=centers,
                           first_idx=np.asarray(first),
                           n_clusters=int(len(first)),
                           finalized_d2=anchors[0] / max(snap.count, 1),
                           finalized_scale=anchors[1],
                           clock=snap.clock, count=snap.count,
                           models=models)

    # ------------------------------------------------------------- serve

    def route(self, sketch=None, *, params=None):
        """Nearest recovered cluster for a (sketch_dim,) / (n, sketch_dim)
        sketch or a raw parameter tree (one client, sketched with the
        session's projection).  One program and one host transfer per
        batch; returns an int or an (n,) int32 array.  Serving stays on
        the last installed round while later waves change the buffers."""
        served = self._served
        if served is None:
            raise ValueError("route() needs finalize() first")
        if (sketch is None) == (params is None):
            raise ValueError("pass exactly one of sketch or params=")
        if params is not None:
            params = self._to_device(params)
            sketch = sketch_tree(params, self.sketch_dim, seed=self.seed,
                                 projection=self._ensure_projection(
                                     self._width(params, stacked=False)),
                                 leaf_filter=self._leaf_filter)
        pts = torch.as_tensor(sketch).to(self.device, torch.float32)
        single = pts.ndim == 1
        pts = (pts[None] if single else pts).contiguous()
        n = int(pts.shape[0])
        if n == 0:
            raise ValueError("route() needs at least one probe "
                             "(got an empty batch)")
        with obs.span("session.route", n=n):
            out, batch_d2 = _route_program()(pts, served.centers)
        obs.count("session.route.requests", n)
        self._routed_d2_sum += batch_d2
        self._routed_n += n
        d = self.drift
        if d is not None:
            obs.gauge("session.drift", d)
        return int(out[0]) if single else out

    def sketch_params(self, wave) -> torch.Tensor:
        """Sketch a stacked parameter wave with the session's projection,
        without ingesting it: the request batches ``route()`` takes."""
        if not tree_leaves(wave):
            raise ValueError("empty parameter wave")
        wave = self._to_device(wave)
        leaves = tree_leaves(wave)
        if int(leaves[0].shape[0]) == 0:
            raise ValueError("sketch_params() needs at least one client "
                             "row (got an empty wave)")
        return self._sketch_wave(wave)

    def cluster_model(self, cluster_id: int):
        """The averaged model of one recovered cluster (no client axis)."""
        served = self._served
        if served is None:
            raise ValueError("cluster_model() needs finalize() first")
        state = served.out[0]
        if state is None:
            raise ValueError("sketch-only session holds no parameters")
        cid = int(cluster_id)
        if not 0 <= cid < served.n_clusters:
            raise IndexError(
                f"cluster id {cid} out of range for {served.n_clusters} "
                "recovered clusters")
        return tree_map(lambda r: r[cid], served.models)

    def cluster_models(self):
        """The (K', ...) averaged models of the served round, one row per
        recovered cluster (replicated under a mesh)."""
        served = self._served
        if served is None:
            raise ValueError("cluster_models() needs finalize() first")
        if served.out[0] is None:
            raise ValueError("sketch-only session holds no parameters")
        return served.models

    @property
    def served_round(self) -> Optional[ServedRound]:
        """The round ``route()`` reads (``None`` before a finalize)."""
        return self._served

    @property
    def finalize_config(self) -> Optional[dict]:
        """The last finalize's arguments (what refinalize replays), or
        ``None`` before any finalize."""
        return (None if self._finalize_kwargs is None
                else dict(self._finalize_kwargs))

    @property
    def n_clusters(self) -> int:
        """Recovered cluster count of the round currently served."""
        served = self._served
        if served is None:
            raise ValueError("finalize() first")
        return served.n_clusters

    @property
    def route_centers(self) -> torch.Tensor:
        """(K', sketch_dim) active centers of the served round."""
        served = self._served
        if served is None:
            raise ValueError("finalize() first")
        return served.centers

    @property
    def drift(self) -> Optional[float]:
        """(mean routed row d^2) / (mean finalized row d^2); a degenerate
        finalize (zero inertia) falls back to the mean row scale as the
        denominator.  ``None`` until one finalize and one route."""
        served = self._served
        if served is None or self._routed_n == 0:
            return None
        routed = self._routed_d2_sum / self._routed_n
        scale = served.finalized_scale or 0.0
        if served.finalized_d2 > 1e-9 * max(scale, 1e-30):
            return routed / served.finalized_d2
        return routed / max(scale, 1e-12)

    # ------------------------------------------------------------- state

    def state(self) -> FederatedState:
        """The live federation as a stacked ``FederatedState`` (its leaves
        ``Shard(0)`` DTensors under a mesh)."""
        if self._mode != "params":
            raise ValueError("state() needs parameter waves")
        rows, sizes = self._held_live()
        params = tree_map(lambda l: self._axis.dtensor(l, sizes),
                          self._held_rows(self._params, rows, sizes))
        return FederatedState(params=params, opt_state=None,
                              n_clients=self._count)
