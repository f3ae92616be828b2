"""AggregationSession: the server side of Algorithm 1 as a long-lived
service (the port of ``repro/core/engine/session.py``).

  * ``ingest(wave)`` / ``ingest(sketches=...)``: step-1 uploads, wave by
    wave.  Parameter waves are sketched on the device and written into a
    fixed-capacity (capacity, sketch_dim) buffer, with the parameters in
    a stacked buffer beside it.  Buffers are updated in place (the
    reference rebinds functional arrays; here an in-place row write saves
    a capacity-sized copy per wave).  With ``client_ids=`` the wave is
    keyed: a returning client's row is replaced in place.
  * ``finalize()``: steps 2-4 over the live rows as two programs, the
    clustering (``session.finalize.cluster``) and the per-cluster mean
    (``session.finalize.mean``); ``snapshot`` / ``compute_round`` /
    ``install_round`` split it for callers that ingest meanwhile.
  * ``route()``: nearest recovered cluster for a batch of never-seen
    clients, one program and ONE host transfer per batch, which also
    feeds the ``drift`` gauge.

Staleness is ``none``: rows live until they are replaced.  Eviction
(and the free list it fills), the other staleness policies,
``refinalize`` and the host engine come later.
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
)
from repro_torch.core.engine.aggregate import (
    _cluster_program,
    _mean_program,
    _route_program,
    compact_labels,
    materialize_round,
)
from repro_torch.core.federated import FederatedState
from repro_torch.core.sketch import (
    jl_projection,
    make_generator,
    sketch_stacked,
    sketch_tree,
)
from repro_torch.device import resolve_device
from repro_torch.utils import tree_leaves, tree_map


class SessionSnapshot(NamedTuple):
    """The live rows at one logical clock tick, copied out of the
    session's buffers (which later waves overwrite in place)."""
    sketches: torch.Tensor         # (count, sketch_dim)
    params: Optional[dict]         # stacked live-params tree or None
    count: int
    clock: int


class ServedRound(NamedTuple):
    """What the serving paths read, published by one attribute write."""
    out: tuple                     # (state | None, labels, info)
    centers: torch.Tensor          # (K', sketch_dim) active centers
    first_idx: np.ndarray          # (K',) one member index per cluster
    n_clusters: int
    finalized_d2: float            # mean row d^2 at finalize (drift anchor)
    finalized_scale: float         # mean row scale (degenerate fallback)
    clock: int
    count: int


def _structure(tree):
    if isinstance(tree, dict):
        return tuple((key, _structure(tree[key])) for key in sorted(tree))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(_structure(t) for t in tree))
    return "leaf"


class AggregationSession:
    """Streaming server-side aggregation over a fixed capacity.

    Args:
      capacity: maximum number of live clients.
      sketch_dim: JL sketch width.
      seed / cluster_seed: seed the JL projection and the clustering's
        generator (a fresh generator per finalize, as the reference
        builds a fresh key).
      projection: an explicit (n, sketch_dim) projection in place of the
        one drawn from ``seed`` (how tests carry the reference's across).
      device: where the buffers live; CUDA unless ``"cpu"`` is asked for.
    """

    def __init__(self, capacity: int, *, sketch_dim: int = 256,
                 seed: int = 0, cluster_seed: Optional[int] = None,
                 projection=None, device=None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.device = resolve_device(device)
        self.capacity = int(capacity)
        self.sketch_dim = int(sketch_dim)
        self.seed = int(seed)
        self.cluster_seed = self.seed if cluster_seed is None else int(
            cluster_seed)
        self._projection = (None if projection is None else
                            torch.as_tensor(projection).to(self.device,
                                                           torch.float32))
        self._sketches = torch.zeros((self.capacity, self.sketch_dim),
                                     dtype=torch.float32, device=self.device)
        self._params = None            # stacked buffer, allocated lazily
        self._mode: Optional[str] = None    # 'params' | 'sketches'
        self._slots: dict = {}         # client id -> buffer row
        self._high = 0                 # rows written: live rows are [0, high)
        self._clock = 0                # logical time, +1 per ingested wave
        self._served: Optional[ServedRound] = None
        self._routed_d2_sum = 0.0
        self._routed_n = 0

    # ------------------------------------------------------------ ingest

    @property
    def count(self) -> int:
        """Live clients (re-uploads replace, they do not add)."""
        return self._high

    @property
    def clients(self) -> dict:
        """Copy of the slot table: client id -> buffer row (keyed waves)."""
        return dict(self._slots)

    @property
    def sketches(self) -> torch.Tensor:
        """Device-resident (count, sketch_dim) view of the live rows."""
        return self._sketches[:self._high]

    @property
    def clock(self) -> int:
        return self._clock

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _ensure_projection(self, n: int) -> torch.Tensor:
        if self._projection is None:
            self._projection = jl_projection(n, self.sketch_dim,
                                             seed=self.seed,
                                             device=self.device)
        if self._projection.shape != (n, self.sketch_dim):
            raise ValueError(
                f"clients flatten to {n} values but the projection is "
                f"{tuple(self._projection.shape)}")
        return self._projection

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

    def _alloc_rows(self, w: int, client_ids) -> np.ndarray:
        """Map a wave onto buffer rows without changing anything:
        returning ids keep their row, new ids (and anonymous waves) extend
        the written rows.  Raises on duplicate ids or a full buffer."""
        high = self._high
        if client_ids is None:
            rows = np.arange(high, high + w, dtype=np.int64)
            high += w
        else:
            ids = list(client_ids)
            if len(ids) != w:
                raise ValueError(f"client_ids has {len(ids)} entries for a "
                                 f"wave of {w}")
            if len(set(ids)) != len(ids):
                raise ValueError("duplicate client ids within one wave")
            rows = np.empty(w, np.int64)
            for i, cid in enumerate(ids):
                row = self._slots.get(cid)
                if row is None:
                    row, high = high, high + 1
                rows[i] = row
        if high > self.capacity:
            raise ValueError(
                f"session capacity exceeded: {self._high} live + "
                f"{high - self._high} new clients > capacity {self.capacity}")
        return rows

    def _commit_rows(self, rows: np.ndarray, client_ids) -> None:
        self._clock += 1
        if client_ids is not None:
            for row, cid in zip(rows, client_ids):
                self._slots[cid] = int(row)
        self._high = max(self._high, int(rows.max()) + 1)

    def _write_rows(self, buf: torch.Tensor, rows: np.ndarray,
                    values: torch.Tensor) -> None:
        start = int(rows[0])
        if np.array_equal(rows, np.arange(start, start + len(rows))):
            buf[start:start + len(rows)] = values
        else:
            buf[torch.as_tensor(rows, device=self.device)] = values

    def ingest(self, wave=None, *, sketches=None, client_ids=None):
        """Ingest one wave of step-1 uploads: a stacked parameter tree (or
        ``FederatedState``) or ``sketches=`` (w, sketch_dim).  Returns the
        row assignment for keyed waves, the wave's offset otherwise."""
        if (wave is None) == (sketches is None):
            raise ValueError("pass exactly one of wave= or sketches=")
        if sketches is not None:
            return self._ingest_sketches(sketches, client_ids)
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
        rows = self._alloc_rows(w, client_ids)
        n = sum(l[0].numel() for l in leaves)
        projection = self._ensure_projection(n)
        self._mode = "params"
        if self._params is None:
            self._params = tree_map(
                lambda l: torch.zeros((self.capacity,) + tuple(l.shape[1:]),
                                      dtype=l.dtype, device=self.device),
                wave)
        offset = int(rows[0])
        with obs.span("session.ingest"):
            self._write_rows(self._sketches, rows,
                             sketch_stacked(wave, projection))
            for buf, l in zip(tree_leaves(self._params), leaves):
                self._write_rows(buf, rows, l)
            self._sync()
        obs.count("session.ingest.clients", w)
        obs.count("session.ingest.bytes",
                  sum(l.numel() * l.element_size() for l in leaves))
        self._commit_rows(rows, client_ids)
        return rows if client_ids is not None else offset

    def _ingest_sketches(self, sketches, client_ids=None):
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
        rows = self._alloc_rows(w, client_ids)
        self._mode = "sketches"
        offset = int(rows[0])
        with obs.span("session.ingest"):
            self._write_rows(self._sketches, rows, sketches)
            self._sync()
        obs.count("session.ingest.clients", w)
        obs.count("session.ingest.bytes",
                  sketches.numel() * sketches.element_size())
        self._commit_rows(rows, client_ids)
        return rows if client_ids is not None else offset

    # ---------------------------------------------------------- finalize

    def snapshot(self) -> SessionSnapshot:
        """Copy the live rows out at the current clock, so a round can be
        computed from them while later waves overwrite the buffers."""
        if self._high == 0:
            raise ValueError("nothing ingested")
        high = self._high
        params = (None if self._params is None else
                  tree_map(lambda l: l[:high].clone(), self._params))
        return SessionSnapshot(sketches=self._sketches[:high].clone(),
                               params=params, count=high, clock=self._clock)

    def finalize(self, *, algorithm="kmeans-device", k: Optional[int] = None,
                 algo_options: Optional[dict] = None, aggregator="mean"):
        """Steps 2-4 over the live rows on the device.  Returns
        ``(new_state, labels, info)`` (``new_state is None`` for
        sketch-only sessions)."""
        return self.finalize_snapshot(
            self.snapshot(), algorithm=algorithm, k=k,
            algo_options=algo_options, aggregator=aggregator)

    def finalize_snapshot(self, snap: SessionSnapshot, **kwargs):
        out, served = self.compute_round(snap, **kwargs)
        return self.install_round(out, served)

    def compute_round(self, snap: SessionSnapshot, *,
                      algorithm="kmeans-device", k: Optional[int] = None,
                      algo_options: Optional[dict] = None,
                      aggregator="mean"):
        """Steps 2-4 over a snapshot without touching the serving state.
        Returns ``(out, served)`` for ``install_round``."""
        algorithm, algo_options = resolve_device_request(algorithm,
                                                         algo_options)
        algo = get_algorithm(algorithm)
        if not is_device_algorithm(algo):
            algo = device_twin(algo)     # "convex" runs as "convex-device"
        k_eff = k if algo.requires_k else None
        with obs.span("session.finalize"):
            generator = make_generator(self.cluster_seed, self.device)
            res = _cluster_program(algo, k_eff, algo_options)(
                generator, snap.sketches)
            if snap.params is None:
                labels, uniq, first = compact_labels(res.labels)
                info = {"n_clusters": int(len(uniq)),
                        "meta": meta_to_host(res.meta), "engine": "device"}
                out = (None, labels, info)
            else:
                new_params = _mean_program(aggregator)(
                    res.labels, res.centers, snap.params)
                state = FederatedState(params=snap.params, opt_state=None,
                                       n_clients=snap.count, step=0)
                new_state, labels, info, uniq, first = materialize_round(
                    new_params, res, state)
                out = (new_state, labels, info)
            info["count"] = snap.count
            info["snapshot_clock"] = snap.clock
            served = self._make_served(out, res, uniq, first, snap)
        return out, served

    def install_round(self, out, served: ServedRound):
        """Publish a computed round (one attribute write) and re-anchor
        the drift gauge."""
        self._served = served
        self._routed_d2_sum = 0.0
        self._routed_n = 0
        return out

    def _make_served(self, out, res, uniq, first, snap) -> ServedRound:
        """Bundle a round with its drift anchor: the clustering's mean row
        inertia, and the mean row scale as the degenerate fallback."""
        sk = snap.sketches
        centred = sk - torch.mean(sk, dim=0, keepdim=True)
        # the Lloyd family's meta inertia is the direct sum of row d^2
        anchors = torch.stack([
            res.meta["inertia"].to(torch.float32),
            torch.mean(torch.sum(centred * centred, dim=1)),
        ]).cpu().tolist()
        idx = torch.as_tensor(uniq, dtype=torch.long, device=self.device)
        return ServedRound(out=out, centers=res.centers[idx].contiguous(),
                           first_idx=np.asarray(first),
                           n_clusters=int(len(uniq)),
                           finalized_d2=anchors[0] / max(snap.count, 1),
                           finalized_scale=anchors[1],
                           clock=snap.clock, count=snap.count)

    # ------------------------------------------------------------- serve

    def route(self, sketch=None, *, params=None):
        """Nearest recovered cluster for a (sketch_dim,) / (n, sketch_dim)
        sketch or a raw parameter tree (one client, sketched with the
        session's projection).  One program and one host transfer per
        batch; returns an int or an (n,) int32 array."""
        served = self._served
        if served is None:
            raise ValueError("route() needs finalize() first")
        if (sketch is None) == (params is None):
            raise ValueError("pass exactly one of sketch or params=")
        if params is not None:
            params = self._to_device(params)
            sketch = sketch_tree(params, self.sketch_dim,
                                 projection=self._ensure_projection(
                                     sum(l.numel()
                                         for l in tree_leaves(params))))
        pts = torch.as_tensor(sketch).to(self.device, torch.float32)
        single = pts.ndim == 1
        pts = (pts[None] if single else pts).contiguous()
        n = int(pts.shape[0])
        if n == 0:
            raise ValueError("route() needs at least one probe "
                             "(got an empty batch)")
        with obs.span("session.route"):
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
        n = sum(l[0].numel() for l in leaves)
        return sketch_stacked(wave, self._ensure_projection(n))

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
        idx = int(served.first_idx[cid])
        return tree_map(lambda l: l[idx], state.params)

    @property
    def served_round(self) -> Optional[ServedRound]:
        return self._served

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
        """The live federation as a stacked ``FederatedState``."""
        if self._mode != "params":
            raise ValueError("state() needs parameter waves")
        high = self._high
        return FederatedState(
            params=tree_map(lambda l: l[:high], self._params),
            opt_state=None, n_clients=high)
