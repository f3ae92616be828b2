"""Two-level hierarchical ODCL, the million-client round (the port of
``repro/core/engine/hierarchy.py``).

k-FED ("Heterogeneity for the Win: One-Shot Federated Clustering") shows
the one-shot estimate composes: cluster each shard of clients on its
own, then cluster the shard-level centers.  ``HierarchicalSession`` is
that composition over S ``AggregationSession`` shards sharing one JL
projection:

  * **ingest** fills shards contiguously (global client order is the
    concatenation of shard orders), splitting waves at shard edges.
    Anonymous waves only: a keyed re-upload would have to find its shard.
  * **finalize** is two levels.  Level 0 runs each shard's own finalize.
    Level 1 clusters the M = sum of the shards' K' centers through a
    sketch-only ``AggregationSession``, then composes:

      - top centers = count-weighted means of the member shard centers,
      - top models  = count-weighted means of the member shard models
        (the engine's ``_mean_program`` with weights),
      - per-client labels = ``top_labels[offset_s + shard_labels]``.

    Both levels' bytes go to ``info["comm_level_bytes"]`` and the
    ``hierarchy.comm.*`` gauges.
  * **route / cluster_model** serve from the composed clustering with
    the session's one-transfer route program.

Each shard's session gets ``row_base`` = its first global client, so a
scenario's sketch hook keyed by client index (the spoof's attacker mask,
the DP noise's wave offset) sees the index the flat session would: the
reference hands each shard's hook the shard-local row instead.  A wave
that straddles a shard edge reaches the hook as one piece per shard, so
what is keyed by row (the spoof) equals the flat session's whatever the
waves, while the DP noise, drawn per piece at its offset, equals the flat
session's only where the waves are aligned to shard edges.

``shards=1`` delegates every call to the one flat session, so it is
bit-exact with the flat round on the same clients.
``hierarchical_one_shot_aggregate`` wraps the session as a function.

Under a mesh (``mesh=`` / ``client_axis=``) every shard session and the
top session shard their client rows over the mesh (each capacity must
divide by the ranks); the shard centers, the cluster models and the
top-level composition are replicated, and the per-client models come
back as ``Shard(0)`` DTensors.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.engine.aggregate import _mean_program, _route_program
from repro_torch.core.engine.session import AggregationSession
from repro_torch.core.federated import FederatedState
from repro_torch.device import resolve_device
from repro_torch.sharding.clients import client_axis_of, shard_of
from repro_torch.utils import tree_leaves, tree_map

_F32 = 4  # bytes per sketch coordinate on the wire


class HierarchicalSession:
    """S-sharded two-level aggregation with the session's serving contract.

    Args:
      capacity: total live-client ceiling, split evenly across shards
        (ceil(capacity / shards) a shard).
      shards: level-0 ``AggregationSession`` count; 1 delegates every call
        to the flat session (bit-exact).
      sketch_dim / cfg / seed / cluster_seed / projection /
        sketch_transform / device: forwarded to every shard session (an
        MoE ``cfg`` sketches only the router-invariant leaves); all
        shards share ``seed`` (or ``projection``), so their JL
        projections, and the sketch space the top level clusters in, are
        identical.
      mesh / client_axis: forwarded to every shard session and to the
        top session.
    """

    def __init__(self, capacity: int, *, shards: int = 1,
                 sketch_dim: int = 256, cfg=None, seed: int = 0,
                 cluster_seed: Optional[int] = None, sketch_transform=None,
                 projection=None, mesh=None, client_axis: str = "data",
                 device=None):
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        if capacity < shards:
            raise ValueError(f"capacity {capacity} < shards {shards}: "
                             "every shard needs at least one slot")
        self.device = resolve_device(device)
        self.shards = int(shards)
        self.capacity = int(capacity)
        self.shard_capacity = -(-self.capacity // self.shards)
        self.sketch_dim = int(sketch_dim)
        self.seed = int(seed)
        self.cluster_seed = self.seed if cluster_seed is None else int(
            cluster_seed)
        self.mesh, self.client_axis = mesh, client_axis
        self._axis = client_axis_of(mesh, client_axis)
        self._sessions = [
            AggregationSession(self.shard_capacity, sketch_dim=sketch_dim,
                               cfg=cfg, seed=seed, cluster_seed=cluster_seed,
                               projection=projection,
                               sketch_transform=sketch_transform,
                               row_base=s * self.shard_capacity,
                               mesh=mesh, client_axis=client_axis,
                               device=self.device)
            for s in range(self.shards)]
        self._fill = 0                 # global clients ingested so far
        # composed top-level serving state (shards > 1 only)
        self._serving = None           # (state | None, labels, info)
        self._route_centers = None     # (K'', sketch_dim) weighted centers
        self._models = None            # (K'', ...) top cluster models
        self._n_clusters = 0

    # ------------------------------------------------------------ ingest

    @property
    def count(self) -> int:
        return sum(s.count for s in self._sessions)

    def ingest(self, wave=None, *, sketches=None, client_ids=None):
        """Ingest one anonymous wave, split at shard edges: clients fill
        shard 0 first, then shard 1, and so on.  Returns the wave's global
        offset."""
        if client_ids is not None:
            raise ValueError(
                "hierarchical sessions are anonymous-only: keyed client "
                "slots (client_ids=) need the flat AggregationSession "
                "(shards=1 via HierarchicalSession delegates to it)")
        if (wave is None) == (sketches is None):
            raise ValueError("pass exactly one of wave= or sketches=")
        if sketches is not None:
            sketches = torch.as_tensor(sketches).to(self.device,
                                                    torch.float32)
            w = int(sketches.shape[0]) if sketches.ndim == 2 else -1
        else:
            if isinstance(wave, FederatedState):
                wave = wave.params
            leaves = tree_leaves(wave)
            if not leaves:
                raise ValueError("empty parameter wave")
            w = int(leaves[0].shape[0])
        if w < 1:
            raise ValueError("empty wave")
        if self._fill + w > self.shard_capacity * self.shards:
            raise ValueError(
                f"hierarchical capacity exceeded: {self._fill} live + {w} "
                f"new > {self.shard_capacity * self.shards}")
        offset = self._fill
        start = 0
        while start < w:
            shard = self._fill // self.shard_capacity
            room = (shard + 1) * self.shard_capacity - self._fill
            take = min(room, w - start)
            if sketches is not None:
                self._sessions[shard].ingest(
                    sketches=sketches[start:start + take])
            else:
                self._sessions[shard].ingest(tree_map(
                    lambda l: l[start:start + take], wave))
            self._fill += take
            start += take
        if self.shards > 1:
            self._serving = None
        return offset

    def _live(self) -> list:
        return [s for s in self._sessions if s.count > 0]

    @property
    def sketches(self) -> torch.Tensor:
        """(count, sketch_dim) live sketch rows in global order (a copy
        for shards > 1); under a mesh, this rank's rows of each shard."""
        if self.shards == 1:
            return self._sessions[0].sketches
        return torch.cat([s.sketches for s in self._live()], dim=0)

    def state(self) -> FederatedState:
        """The live federation as one stacked ``FederatedState`` (the
        shard states concatenated in global order)."""
        if self.shards == 1:
            return self._sessions[0].state()
        axis = self._axis
        states = [s.state() for s in self._live()]
        params = tree_map(lambda *ls: axis.from_full(torch.cat(
            [axis.full(l) for l in ls], dim=0)), *[st.params for st in states])
        return FederatedState(params=params, opt_state=None,
                              n_clients=self.count)

    def sketch_params(self, wave) -> torch.Tensor:
        """Sketch a stacked parameter wave with the shared projection,
        without ingesting it."""
        return self._sessions[0].sketch_params(wave)

    # ---------------------------------------------------------- finalize

    def finalize(self, *, algorithm="kmeans-device", k: Optional[int] = None,
                 algo_options: Optional[dict] = None, engine: str = "device",
                 aggregator="mean"):
        """Two-level steps 2-4, with ``AggregationSession.finalize``'s
        ``(new_state, labels, info)`` contract; ``info`` adds ``shards``,
        ``per_shard_clusters`` and ``comm_level_bytes``."""
        if self.count == 0:
            raise ValueError("nothing ingested")
        kwargs = dict(algorithm=algorithm, k=k, algo_options=algo_options,
                      engine=engine, aggregator=aggregator)
        if self.shards == 1:
            out = self._sessions[0].finalize(**kwargs)
            out[2].setdefault("shards", 1)
            self._serving = out
            return out
        with obs.span("hierarchy.finalize", shards=self.shards,
                      count=self.count):
            return self._finalize_two_level(**kwargs)

    def _finalize_two_level(self, *, algorithm, k, algo_options, engine,
                            aggregator):
        live = self._live()
        # ---- level 0: each shard's own round ---------------------------
        with obs.span("hierarchy.level0", shards=len(live)):
            rounds = [s.finalize(algorithm=algorithm, k=k,
                                 algo_options=algo_options, engine=engine,
                                 aggregator=aggregator) for s in live]
        offsets = np.cumsum([0] + [s.n_clusters for s in live])
        top_points = torch.cat([s.route_centers for s in live], dim=0)
        counts = np.concatenate([
            np.bincount(labels_s, minlength=s.n_clusters)
            for s, (_, labels_s, _) in zip(live, rounds)])
        m_top = int(top_points.shape[0])
        level0_bytes = self.count * self.sketch_dim * _F32
        level1_bytes = m_top * (self.sketch_dim + 1) * _F32  # + the count
        obs.gauge("hierarchy.comm.level0_bytes", float(level0_bytes))
        obs.gauge("hierarchy.comm.level1_bytes", float(level1_bytes))
        obs.gauge("hierarchy.top_points", float(m_top))

        # ---- level 1: cluster the count-weighted shard centers ---------
        k_top = None if k is None else min(int(k), m_top)
        with obs.span("hierarchy.level1", points=m_top):
            top = AggregationSession(m_top, sketch_dim=self.sketch_dim,
                                     seed=self.seed,
                                     cluster_seed=self.cluster_seed,
                                     mesh=self.mesh,
                                     client_axis=self.client_axis,
                                     device=self.device)
            top.ingest(sketches=top_points)
            _, top_labels, top_info = top.finalize(
                algorithm=algorithm, k=k_top, algo_options=algo_options,
                engine=engine, aggregator="mean")
        k2 = int(top_info["n_clusters"])
        w_t = torch.as_tensor(counts, dtype=torch.float32,
                              device=self.device)
        lab_t = torch.as_tensor(top_labels, dtype=torch.int64,
                                device=self.device)
        # count-weighted top centers: the sketch mean of each top
        # cluster's member clients (shard centers are member means); a
        # one-hot product, the same sums on every run
        onehot = torch.nn.functional.one_hot(lab_t, k2).to(torch.float32)
        sums = onehot.T @ (w_t[:, None] * top_points)
        denom = torch.clamp_min(onehot.T @ w_t, 1e-12)
        top_centers = sums / denom[:, None]

        # ---- compose ---------------------------------------------------
        global_rows = np.concatenate([offsets[i] + labels_s
                                      for i, (_, labels_s, _)
                                      in enumerate(rounds)])
        labels = top_labels[global_rows]
        info = {
            "n_clusters": k2,
            "engine": top_info["engine"],
            "count": self.count,
            "meta": top_info["meta"],
            "shards": len(live),
            "per_shard_clusters": [s.n_clusters for s in live],
            "comm_level_bytes": {"level0": level0_bytes,
                                 "level1": level1_bytes},
        }
        new_state = None
        if rounds[0][0] is not None:
            # (M, ...) shard-cluster models -> the (K'', ...) weighted top
            # means, then one row per client (this rank's under a mesh)
            stacked = tree_map(lambda *ls: torch.cat(ls, dim=0),
                               *[s.cluster_models() for s in live])
            _, self._models = _mean_program()(
                lab_t, top_centers, stacked, shard_of(top_points), w_t)
            client_top = torch.as_tensor(top_labels[global_rows],
                                         dtype=torch.int64,
                                         device=self.device)
            per_client = tree_map(
                lambda l: self._axis.expand(l, client_top), self._models)
            new_state = FederatedState(params=per_client, opt_state=None,
                                       n_clients=self.count, step=0)
        self._route_centers = top_centers
        self._n_clusters = k2
        self._serving = (new_state, labels, info)
        return new_state, labels, info

    # ------------------------------------------------------------- serve

    def route(self, sketch=None, *, params=None):
        """Nearest composed top-level cluster, one host transfer a batch:
        the flat session's serving contract over the hierarchy."""
        if self.shards == 1:
            return self._sessions[0].route(sketch, params=params)
        if self._serving is None:
            raise ValueError("route() needs finalize() first")
        if (sketch is None) == (params is None):
            raise ValueError("pass exactly one of sketch or params=")
        if params is not None:
            sketch = self.sketch_params(tree_map(
                lambda l: torch.as_tensor(l)[None], params))[0]
        pts = torch.as_tensor(sketch).to(self.device, torch.float32)
        single = pts.ndim == 1
        pts = (pts[None] if single else pts).contiguous()
        with obs.span("hierarchy.route", n=int(pts.shape[0])):
            out, _ = _route_program()(pts, self._route_centers)
        return int(out[0]) if single else out

    def cluster_model(self, cluster_id: int):
        if self.shards == 1:
            return self._sessions[0].cluster_model(cluster_id)
        state = self._require_serving()[0]
        if state is None:
            raise ValueError("sketch-only session holds no parameters")
        cid = int(cluster_id)
        if not 0 <= cid < self._n_clusters:
            raise IndexError(
                f"cluster id {cid} out of range for {self._n_clusters} "
                "recovered clusters")
        return tree_map(lambda l: l[cid], self._models)

    def cluster_models(self):
        """The (K'', ...) top cluster models, one row per cluster."""
        if self.shards == 1:
            return self._sessions[0].cluster_models()
        if self._require_serving()[0] is None:
            raise ValueError("sketch-only session holds no parameters")
        return self._models

    def _require_serving(self):
        if self._serving is None:
            raise ValueError("finalize() first")
        return self._serving

    @property
    def n_clusters(self) -> int:
        if self.shards == 1:
            return self._sessions[0].n_clusters
        self._require_serving()
        return self._n_clusters

    @property
    def route_centers(self) -> torch.Tensor:
        if self.shards == 1:
            return self._sessions[0].route_centers
        self._require_serving()
        return self._route_centers

    @property
    def drift(self) -> Optional[float]:
        """The flat session's drift gauge; the composed round keeps none."""
        return self._sessions[0].drift if self.shards == 1 else None


def hierarchical_one_shot_aggregate(state: FederatedState, cfg=None, *,
                                    shards: int,
                                    algorithm="kmeans-device",
                                    k: Optional[int] = None,
                                    algo_options: Optional[dict] = None,
                                    sketch_dim: int = 256, seed: int = 0,
                                    cluster_seed: Optional[int] = None,
                                    aggregator="mean",
                                    engine: str = "device",
                                    projection=None, mesh=None,
                                    client_axis: str = "data", device=None):
    """The two-level round as one call, with ``one_shot_aggregate``'s
    ``(new_state, labels, info)`` contract.  ``shards=1`` is bit-exact
    with the flat session's round.  Runs on CUDA unless
    ``device="cpu"``.  Under a ``mesh`` every rank passes the whole
    state and keeps its rows of each shard."""
    sess = HierarchicalSession(state.n_clients, shards=shards,
                               sketch_dim=sketch_dim, cfg=cfg, seed=seed,
                               cluster_seed=cluster_seed,
                               projection=projection, mesh=mesh,
                               client_axis=client_axis, device=device)
    cap = sess.shard_capacity
    for start in range(0, state.n_clients, cap):
        stop = min(start + cap, state.n_clients)
        sess.ingest(tree_map(lambda l: torch.as_tensor(l)[start:stop],
                             state.params))
    return sess.finalize(algorithm=algorithm, k=k, algo_options=algo_options,
                         engine=engine, aggregator=aggregator)
