"""The federated-method API over deep-model federations (the port of
``repro/core/federated_methods.py``).

  ``FederatedMethod.run(key, state, cfg, batches, *, mesh=None,
  client_axis="data") -> FederatedMethodResult``

``state`` carries stacked per-client parameters (leading axis C); ``cfg``
is the ``ModelConfig`` driving local training (``None`` for shallow
per-client models, e.g. the ridge clients of ``launch/simulate.py``);
``batches`` yields dicts of (C, b, s) arrays (``None`` when the method
runs no local step).  ``key`` is an int seed or a ``torch.Generator``
(IFCA's ``init="perturb"`` draws from it).  ``mesh`` / ``client_axis``:
ODCL runs its round with the client axis on that mesh dim
(``one_shot_aggregate``); IFCA, FedAvg and local-only take them and do
not use them, as in the reference.

Every method runs on a federation whose client axis is sharded over a
mesh (``Shard(0)`` DTensors, ``init_federation(mesh=)``), with or
without ``mesh=``: the axis is the one the leaves lie on.  Each rank
trains, scores and sketches its own clients; the cross-rank traffic is
the round's, the gathered (C,) losses and labels, and the per-cluster
(IFCA) or global (FedAvg) averages, which all-reduce their sums and
counts.  The reference returns IFCA's and FedAvg's parameters replicated
(``P()``); the port keeps them ``Shard(0)``, each rank writing its own
clients' rows, so parity with it is on values.

Registered methods: ``ODCLFederated`` (Algorithm 1: local steps, the ONE
clustered round, optional personalized steps), ``IFCAFederated`` (the
iterative baseline, with the lowest-loss or the sketch assignment),
``FedAvgGlobal`` and ``LocalOnlyFederated``.

A method consumes the state it is given: local steps advance its
tensors in place and the rounds reuse its AdamW buffers (a model of
494 M parameters has 32 GB of fp32 moments at C = 8).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Iterator, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.clustering.api import (
    get_algorithm,
    resolve_device_request,
)
from repro_torch.core.engine.aggregators import cluster_reps
from repro_torch.core.federated import (
    FederatedState,
    _leaf_filter_for,
    cluster_agreement,
    local_training,
    one_shot_aggregate,
    params_bytes_per_client,
    sketch_round_bytes,
)
from repro_torch.core.sketch import sketch_stacked
from repro_torch.kernels import ops as kops
from repro_torch.optim import AdamWConfig, adamw_init, adamw_reset_
from repro_torch.sharding.clients import tree_axis
from repro_torch.utils import tree_leaves, tree_map

__all__ = [
    "FederatedMethod", "FederatedMethodResult", "ODCLFederated",
    "IFCAFederated", "FedAvgGlobal", "LocalOnlyFederated",
    "register_federated_method", "unregister_federated_method",
    "get_federated_method", "list_federated_methods",
    "build_federated_method", "cluster_agreement",
    "params_bytes_per_client", "sketch_round_bytes",
]


@dataclasses.dataclass
class FederatedMethodResult:
    """What every LM-scale federated method hands back to the driver."""
    state: FederatedState              # final per-client params/opt state
    labels: np.ndarray                 # (C,) cluster id per client
    n_clusters: int
    comm_rounds: float                 # server<->client round trips consumed
    comm_bytes: float                  # protocol bytes moved (up + down)
    round_metrics: list                # one dict per round (losses, churn, ...)
    meta: dict


@runtime_checkable
class FederatedMethod(Protocol):
    """A federated method runnable over a ``FederatedState``."""
    name: str

    def run(self, key, state: FederatedState, cfg,
            batches: Optional[Iterator], *, mesh=None,
            client_axis: str = "data") -> FederatedMethodResult: ...


def _generator(key, device) -> torch.Generator:
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator(device=device).manual_seed(
        0 if key is None else int(key))


def _require_training_inputs(name: str, cfg, batches, steps: int):
    if steps > 0 and (cfg is None or batches is None):
        raise ValueError(
            f"{name} with local steps > 0 needs a ModelConfig and a batch "
            "iterator; pass local_steps=0 for shallow aggregate-only runs")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _fresh_opt_state(state: FederatedState, params) -> dict:
    """AdamW moments of zeros for ``params``: the state's own buffers
    zeroed in place when their shapes match, else a new ``adamw_init``."""
    old = state.opt_state
    if old is not None and [t.shape for t in tree_leaves(old["mu"])] == [
            p.shape for p in tree_leaves(params)]:
        return adamw_reset_(old)
    return adamw_init(params, state.n_clients)


# ---------------------------------------------------------------- ODCL

@dataclasses.dataclass
class ODCLFederated:
    """Algorithm 1 end to end at LM scale.

    Phase 1: ``local_steps`` per-client AdamW steps.  Phase 2:
    ``one_shot_aggregate``: sketch, cluster through the admissible
    registry (``algorithm`` / ``k``), per-cluster parameter reduction
    (``aggregator``).  Phase 3: ``post_steps`` personalized steps.
    ``engine='device'`` maps the host Lloyd-family names onto
    ``kmeans-device`` init options (``resolve_device_request``).
    ``projection`` (tests) replaces the JL projection drawn from
    ``seed``."""
    algorithm: str = "kmeans++"
    k: Optional[int] = None
    algo_options: Optional[dict] = None
    engine: str = "host"               # host | device | auto
    sketch_dim: int = 128
    local_steps: int = 0
    post_steps: int = 0
    opt: Optional[AdamWConfig] = None
    seed: int = 0
    aggregator: Any = "mean"
    projection: Any = None
    name: str = "odcl"

    def _resolve(self):
        if self.engine != "device":
            return self.algorithm, self.algo_options
        return resolve_device_request(self.algorithm, self.algo_options)

    def run(self, key, state: FederatedState, cfg,
            batches=None, *, mesh=None,
            client_axis: str = "data") -> FederatedMethodResult:
        _require_training_inputs(self.name, cfg, batches,
                                 self.local_steps + self.post_steps)
        rounds = []
        if self.local_steps:
            state, losses = local_training(state, cfg, batches,
                                           self.local_steps, self.opt)
            rounds.append({"phase": "local", "steps": self.local_steps,
                           "loss_first": float(np.mean(losses[0])),
                           "loss_last": float(np.mean(losses[-1])),
                           "losses": [float(np.mean(l)) for l in losses],
                           "client_losses": [l.tolist() for l in losses]})

        algorithm, options = self._resolve()
        k = self.k if get_algorithm(algorithm).requires_k else None
        device = tree_leaves(state.params)[0].device
        opt = state.opt_state
        t0 = time.perf_counter()
        state, labels, info = one_shot_aggregate(
            state, cfg, algorithm=algorithm, k=k, algo_options=options,
            engine=self.engine, sketch_dim=self.sketch_dim, seed=self.seed,
            aggregator=self.aggregator, projection=self.projection,
            mesh=mesh, client_axis=client_axis, device=device)
        if opt is not None:
            # the round leaves the moments to their owner: zeroed in place
            state = state._replace(opt_state=adamw_reset_(opt))
        _sync(device)
        round_s = time.perf_counter() - t0
        rounds.append({"phase": "aggregate", "engine": info["engine"],
                       "n_clusters": info["n_clusters"],
                       "round_ms": round_s * 1e3})

        if self.post_steps:
            state, losses = local_training(state, cfg, batches,
                                           self.post_steps, self.opt)
            rounds.append({"phase": "post", "steps": self.post_steps,
                           "loss_last": float(np.mean(losses[-1])),
                           "losses": [float(np.mean(l)) for l in losses],
                           "client_losses": [l.tolist() for l in losses]})

        bytes_per = params_bytes_per_client(state)
        comm = sketch_round_bytes(state.n_clients, self.sketch_dim,
                                  bytes_per)
        obs.count("fed.comm_bytes", comm)
        obs.observe("fed.round.ms", round_s * 1000.0)
        obs.event("fed.round", method=self.name, round=0, seconds=round_s,
                  bytes=float(comm), clients=state.n_clients,
                  n_clusters=info["n_clusters"])
        return FederatedMethodResult(
            state=state, labels=np.asarray(labels),
            n_clusters=info["n_clusters"], comm_rounds=1.0,
            comm_bytes=float(comm), round_metrics=rounds,
            meta={"engine": info["engine"], **info["meta"]})


# ---------------------------------------------------------------- IFCA

@dataclasses.dataclass
class IFCAFederated:
    """IFCA [Ghosh et al., 2020] on model trees, the multi-round baseline
    the one-shot framework is measured against (Figure 4).

    Per round the server broadcasts k cluster models; every client
    estimates its cluster (``assign='loss'``: the lowest local loss of
    the k candidates, ties to the lowest index; ``assign='sketch'``: the
    nearest cluster model in JL sketch space, through ``kmeans_assign``);
    clients run ``local_steps`` AdamW steps from their cluster's model;
    the server re-averages within the assigned clusters (an empty
    cluster keeps its model).  ``warmup_steps`` of local training come
    first; ``init='clients'`` seeds the k models with k spread clients,
    ``init='perturb'`` with the client mean plus ``init_scale`` N(0, 1)
    noise drawn from ``key`` (or ``perturb_noise``: a tree of (k, ...)
    unscaled draws, how tests carry the reference's across).
    ``carry_opt_state``: per-cluster AdamW moments averaged with the
    parameters and handed back next round.  ``projection`` (tests)
    replaces the sketch's JL projection drawn from ``seed``."""
    k: int = 2
    rounds: int = 5
    local_steps: int = 5
    warmup_steps: int = 0
    assign: str = "loss"               # 'loss' | 'sketch'
    init: str = "perturb"              # 'perturb' | 'clients'
    init_scale: float = 1e-2
    sketch_dim: int = 128
    carry_opt_state: bool = False
    opt: Optional[AdamWConfig] = None
    seed: int = 0
    aggregator: Any = "mean"
    perturb_noise: Any = None
    projection: Any = None
    name: str = "ifca"

    def _theta0(self, key, state: FederatedState, axis):
        """The k initial cluster models, replicated on every rank."""
        n = state.n_clients
        if self.init == "clients":
            idx = torch.as_tensor(
                np.linspace(0, n - 1, self.k).round().astype(np.int64),
                device=tree_leaves(state.params)[0].device)
            return tree_map(lambda l: axis.even(n).take_rows(
                axis.local_rows(l, n), idx), state.params)
        if self.init == "perturb":
            leaves = tree_leaves(state.params)
            noise = (tree_leaves(self.perturb_noise)
                     if self.perturb_noise is not None else None)
            gen = (None if noise is not None
                   else _generator(key, leaves[0].device))
            out = []
            for i, leaf in enumerate(leaves):
                # the clients' mean: fp32 sums of the rank's rows,
                # all-reduced, over n (what the CPU's torch.mean computes)
                mean = (axis.all_reduce(torch.sum(
                    axis.local_rows(leaf, n), dim=0, dtype=torch.float32))
                    / n).to(leaf.dtype)
                draw = (torch.as_tensor(noise[i]).to(mean.device, leaf.dtype)
                        if noise is not None else
                        torch.randn((self.k,) + tuple(mean.shape),
                                    generator=gen, device=mean.device,
                                    dtype=torch.float32).to(leaf.dtype))
                out.append(mean[None] + self.init_scale * draw)
            it = iter(out)
            return tree_map(lambda _: next(it), state.params)
        raise ValueError(f"unknown init {self.init!r}")

    def _assign(self, cfg, leaf_filter, theta, params, batch):
        """The cluster estimate of each client of ``params`` (this rank's
        rows): (m,) int32 on the parameters' device."""
        if self.assign == "loss":
            from repro_torch.launch.steps import _as_batch, client_slice
            from repro_torch.models.transformer import train_loss

            batch = _as_batch(batch, tree_leaves(params)[0].device)
            with torch.no_grad():
                losses = torch.stack([
                    torch.stack([train_loss(client_slice(theta, j), cfg,
                                            client_slice(batch, c))
                                 for j in range(self.k)])
                    for c in range(int(tree_leaves(params)[0].shape[0]))])
            # argmin keeps the first minimum: ties go to the lowest index
            return torch.argmin(losses, dim=1).to(torch.int32)
        if self.assign == "sketch":
            def sk(tree):
                return sketch_stacked(tree, self.projection,
                                      sketch_dim=self.sketch_dim,
                                      seed=self.seed, leaf_filter=leaf_filter)
            # nearest center through the fused assign kernel: no
            # (C, k, sketch_dim) difference block
            labels, _, _ = kops.kmeans_assign(sk(params), sk(theta))
            return labels
        raise ValueError(f"unknown assign rule {self.assign!r}")

    def run(self, key, state: FederatedState, cfg,
            batches=None, *, mesh=None,
            client_axis: str = "data") -> FederatedMethodResult:
        if self.rounds < 1:
            raise ValueError("IFCA needs rounds >= 1 (there is no "
                             "assignment without a round)")
        if self.assign not in ("loss", "sketch"):
            raise ValueError(f"unknown assign rule {self.assign!r}")
        if self.assign == "loss" and (cfg is None or batches is None):
            raise ValueError("assign='loss' needs a ModelConfig and batches; "
                             "use assign='sketch' for shallow states")
        _require_training_inputs(self.name, cfg, batches,
                                 self.warmup_steps + self.local_steps)
        if self.warmup_steps:
            state, _ = local_training(state, cfg, batches, self.warmup_steps,
                                      self.opt)
        n = state.n_clients
        axis = tree_axis(state.params)
        shard = axis.even(n)
        lo, hi = axis.owned(n)
        device = tree_leaves(state.params)[0].device
        theta = self._theta0(key, state, axis)
        leaf_filter = _leaf_filter_for(cfg)
        local_step = None
        if self.local_steps:
            from repro_torch.launch.steps import make_local_train_step
            # remat="none", as local_training (the warmup / ODCL path)
            local_step = make_local_train_step(cfg, self.opt, remat="none")
        cluster_opt = (adamw_init(theta, self.k)
                       if self.carry_opt_state and self.local_steps else None)

        bytes_per = params_bytes_per_client(state)
        if self.assign == "loss":
            # down: k models per client; up: one trained model per client
            per_round = n * (self.k + 1) * bytes_per
        else:
            # up: sketch + trained model; down: the assigned model
            per_round = sketch_round_bytes(n, self.sketch_dim, bytes_per)

        params, opt_state = state.params, state.opt_state
        mine = axis.mine(params, n)          # this rank's clients (views)
        labels, rounds = None, []
        for r in range(self.rounds):
            t0 = time.perf_counter()
            batch = None
            if self.assign == "loss":
                batch = axis.mine(next(batches), n)
            new_labels = axis.gather_clients(
                self._assign(cfg, leaf_filter, theta, mine, batch), n)
            idx = new_labels.long()
            host = new_labels.cpu().numpy()
            churn = (float(np.mean(host != labels))
                     if labels is not None else 1.0)
            labels = host

            losses, client_losses = [], []
            if self.local_steps:
                # clients adopt their cluster's model (and moments) and
                # refine it locally; the state's buffers take them
                for dst, src in zip(tree_leaves(mine), tree_leaves(theta)):
                    dst.copy_(src[idx[lo:hi]])
                if opt_state is None:
                    opt_state = adamw_init(params, n)
                if cluster_opt is not None:
                    for dst, src in zip(tree_leaves(axis.mine(opt_state, n)),
                                        tree_leaves(cluster_opt)):
                        dst.copy_(src[idx[lo:hi]])
                else:
                    adamw_reset_(opt_state)
                for _ in range(self.local_steps):
                    ts = time.perf_counter()
                    loss, params, opt_state = local_step(params, opt_state,
                                                         next(batches))
                    loss = axis.gather_clients(loss, n)
                    losses.append(float(torch.mean(loss)))
                    client_losses.append(loss.cpu().numpy().tolist())
                    obs.observe("fed.local_step.ms",
                                (time.perf_counter() - ts) * 1e3)
            # local_steps == 0: clients upload their standing models, so
            # the rounds are Lloyd steps in model space

            onehot = torch.nn.functional.one_hot(idx, self.k).to(
                torch.float32)
            counts = torch.sum(onehot, dim=0)                      # (k,)
            hit = counts > 0

            def keep(mean, prev):
                mask = hit.reshape((self.k,) + (1,) * (mean.ndim - 1))
                return torch.where(mask, mean, prev)

            # where every cluster has members the means replace the k
            # models as they are, and the old ones go first (at full width
            # each set of k models is k GB)
            every = bool(hit.all())
            if every:
                theta = None
            means = cluster_reps(shard.local_part(new_labels), self.k, mine,
                                 self.aggregator, shard)
            theta = means if every else tree_map(keep, means, theta)
            del means
            if cluster_opt is not None:
                # per-cluster moment means; the integer step is uniform
                # within a cluster, so its mean is exact
                opt_means = cluster_reps(shard.local_part(new_labels),
                                         self.k, axis.mine(opt_state, n),
                                         "mean", shard)
                cluster_opt = tree_map(keep, opt_means, cluster_opt)
            _sync(device)
            round_s = time.perf_counter() - t0
            obs.count("fed.comm_bytes", per_round)
            obs.observe("fed.round.ms", round_s * 1000.0)
            obs.event("fed.round", method=self.name, round=r,
                      seconds=round_s, bytes=float(per_round),
                      clients=n, churn=churn)
            rounds.append({"round": r, "assign_churn": churn,
                           "cluster_sizes": counts.cpu().numpy().tolist(),
                           "loss_last": losses[-1] if losses else None,
                           "losses": losses, "client_losses": client_losses,
                           "round_ms": round_s * 1e3})

        if not self.local_steps:
            # each client receives its final cluster's averaged model
            idx = torch.as_tensor(labels, device=device).long()
            params = tree_map(lambda t: axis.expand(t, idx), theta)
        new_state = FederatedState(
            params=params,
            opt_state=_fresh_opt_state(
                state._replace(opt_state=opt_state), params),
            n_clients=n,
            step=state.step + self.rounds * self.local_steps)
        return FederatedMethodResult(
            state=new_state, labels=labels,
            n_clusters=int(len(np.unique(labels))),
            comm_rounds=float(self.rounds),
            comm_bytes=float(self.rounds * per_round), round_metrics=rounds,
            meta={"assign": self.assign, "k": self.k,
                  "warmup_steps": self.warmup_steps,
                  "carry_opt_state": self.carry_opt_state})


# ------------------------------------------------------------- baselines

@dataclasses.dataclass
class FedAvgGlobal:
    """R rounds of global FedAvg, the heterogeneity-blind baseline (every
    round averages ALL clients into one model, K' = 1)."""
    rounds: int = 5
    local_steps: int = 5
    opt: Optional[AdamWConfig] = None
    name: str = "fedavg"

    def run(self, key, state: FederatedState, cfg,
            batches=None, *, mesh=None,
            client_axis: str = "data") -> FederatedMethodResult:
        _require_training_inputs(self.name, cfg, batches, self.local_steps)
        c = state.n_clients
        device = tree_leaves(state.params)[0].device
        zeros = torch.zeros((c,), dtype=torch.int32, device=device)
        per_round = c * 2 * params_bytes_per_client(state)
        rounds = []
        for r in range(self.rounds):
            t0 = time.perf_counter()
            if self.local_steps:
                state, losses = local_training(state, cfg, batches,
                                               self.local_steps, self.opt)
                rounds.append({"round": r,
                               "loss_last": float(np.mean(losses[-1]))})
            # the one global mean (its sums all-reduced under a mesh),
            # written back into every client's row (each rank its own)
            axis = tree_axis(state.params)
            shard = axis.even(c)
            mean = cluster_reps(shard.local_part(zeros), 1,
                                axis.mine(state.params, c), "mean", shard)
            params = tree_map(lambda m: axis.expand(m, zeros), mean)
            state = FederatedState(params=params,
                                   opt_state=_fresh_opt_state(state, params),
                                   n_clients=c, step=state.step)
            _sync(device)
            round_s = time.perf_counter() - t0
            obs.count("fed.comm_bytes", per_round)
            obs.observe("fed.round.ms", round_s * 1000.0)
            obs.event("fed.round", method=self.name, round=r,
                      seconds=round_s, bytes=float(per_round), clients=c)
        bytes_per = params_bytes_per_client(state)
        return FederatedMethodResult(
            state=state, labels=np.zeros(c, np.int32), n_clusters=1,
            comm_rounds=float(self.rounds),
            comm_bytes=float(self.rounds * c * 2 * bytes_per),
            round_metrics=rounds, meta={})


@dataclasses.dataclass
class LocalOnlyFederated:
    """Pure local training: every client keeps its own model (0 rounds)."""
    local_steps: int = 0
    opt: Optional[AdamWConfig] = None
    name: str = "local-only"

    def run(self, key, state: FederatedState, cfg,
            batches=None, *, mesh=None,
            client_axis: str = "data") -> FederatedMethodResult:
        rounds = []
        if self.local_steps:
            _require_training_inputs(self.name, cfg, batches,
                                     self.local_steps)
            state, losses = local_training(state, cfg, batches,
                                           self.local_steps, self.opt)
            rounds.append({"phase": "local",
                           "loss_last": float(np.mean(losses[-1]))})
        return FederatedMethodResult(
            state=state,
            labels=np.arange(state.n_clients, dtype=np.int32),
            n_clusters=state.n_clients, comm_rounds=0.0, comm_bytes=0.0,
            round_metrics=rounds, meta={})


# ------------------------------------------------------------- registry

_FEDERATED_METHODS: dict = {}


def register_federated_method(cls: type, *, name: Optional[str] = None,
                              overwrite: bool = False) -> type:
    """Register a method under a name.  Returns it (decorator-safe)."""
    key = name if name is not None else getattr(cls, "name", None)
    if not isinstance(key, str) or not key:
        key = cls.__name__.lower()
    if key in _FEDERATED_METHODS and not overwrite:
        raise ValueError(f"federated method {key!r} already registered "
                         "(pass overwrite=True to replace)")
    _FEDERATED_METHODS[key] = cls
    return cls


def unregister_federated_method(name: str) -> None:
    """Remove a registered method (used by tests and plugins)."""
    _FEDERATED_METHODS.pop(name, None)


def get_federated_method(name: str) -> type:
    try:
        return _FEDERATED_METHODS[name]
    except KeyError:
        raise KeyError(f"unknown federated method {name!r}; "
                       f"registered: {sorted(_FEDERATED_METHODS)}") from None


def list_federated_methods() -> tuple:
    return tuple(sorted(_FEDERATED_METHODS))


def build_federated_method(name: str, **kwargs: Any):
    """Construct a registered method from a superset of driver kwargs: the
    fields the named method declares, the ``None`` ones dropped."""
    cls = get_federated_method(name)
    if dataclasses.is_dataclass(cls):
        fields = {f.name for f in dataclasses.fields(cls) if f.init}
        kwargs = {k: v for k, v in kwargs.items()
                  if k in fields and v is not None}
    return cls(**kwargs)


for _cls, _name in ((ODCLFederated, "odcl"), (IFCAFederated, "ifca"),
                    (FedAvgGlobal, "fedavg"),
                    (LocalOnlyFederated, "local-only")):
    register_federated_method(_cls, name=_name)
del _cls, _name
