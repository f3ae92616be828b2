"""One server-side API for every federated method of the paper (the port
of ``repro/core/methods.py``).

One protocol, ``Method.fit(key, xs, ys, erm) -> MethodResult``, covers
the paper's Section-5 cast:

  * ``ODCL``            Algorithm 1 over any registered admissible
                        clustering algorithm (``core/odcl.py``).
  * ``IFCA``            the iterative baseline [Ghosh et al., 2020].
  * ``GlobalERM``       naive all-users averaging.
  * ``LocalOnly``       every user keeps its local ERM (0 rounds).
  * ``OracleAveraging`` averaging within the TRUE clusters.
  * ``ClusterOracle``   centralized training on pooled true clusters.

``key`` is a ``torch.Generator`` or an int seed (a generator on the
method's device is made from it).  ``erm`` is the batched local solver
``erm(xs, ys) -> (m, d)`` (numpy or a tensor; a tensor is used on its
device); methods that do not use local ERMs (IFCA) ignore it.  ODCL and
IFCA run on ``device`` (CUDA unless "cpu"); the baselines are numpy.
``MethodResult`` carries numpy per-user models, labels, comm-round
counts, and MSE-vs-oracle accessors.  A name registry
(``register_method`` / ``get_method`` / ``list_methods``) makes new
methods drop-in plugins.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core import oracles
from repro_torch.core.clustering.api import get_algorithm
from repro_torch.core.ifca import IFCAConfig, ifca
from repro_torch.core.odcl import aggregate, run_clustering
from repro_torch.core.sketch import make_generator
from repro_torch.device import resolve_device


@dataclasses.dataclass
class MethodResult:
    """What every federated method hands back to its caller."""
    user_models: np.ndarray            # (m, d) model each user ends with
    labels: np.ndarray                 # (m,) cluster id per user
    cluster_models: Optional[np.ndarray]  # (K', d) shared models, if any
    n_clusters: int
    comm_rounds: float                 # uplink+downlink rounds consumed
    meta: dict

    def mse(self, optima, true_labels) -> float:
        """Mean squared parameter error vs the true per-user optimum."""
        opt = np.asarray(optima)[np.asarray(true_labels)]
        return float(np.mean(np.sum((self.user_models - opt) ** 2, axis=1)))

    def nmse(self, optima, true_labels, eps: float = 0.0) -> float:
        """Per-user normalized MSE (the paper's Figure-1/2 metric)."""
        opt = np.asarray(optima)[np.asarray(true_labels)]
        num = np.sum((self.user_models - opt) ** 2, axis=1)
        den = np.sum(opt ** 2, axis=1)
        if eps:
            den = np.maximum(den, eps)
        return float(np.mean(num / den))


ERMSolver = Callable[[Any, Any], Any]   # erm(xs, ys) -> (m, d) models


@runtime_checkable
class Method(Protocol):
    """A federated method the server can run end to end."""
    name: str

    def fit(self, key, xs, ys, erm: Optional[ERMSolver] = None
            ) -> MethodResult: ...


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def _local_models(erm: Optional[ERMSolver], xs, ys):
    """The users' local ERMs: a tensor stays on its device, anything else
    becomes float32 numpy."""
    if erm is None:
        raise ValueError("this method needs a batched local ERM solver "
                         "erm(xs, ys) -> (m, d)")
    local = erm(xs, ys)
    if isinstance(local, torch.Tensor):
        return local.to(torch.float32)
    return _host(local)


def _on(x, device) -> torch.Tensor:
    """A tensor on ``device`` (float32) from a tensor or an array."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, np.float32))
    return x.to(device, torch.float32)


def _generator(key, device) -> torch.Generator:
    if isinstance(key, torch.Generator):
        return key
    return make_generator(0 if key is None else int(key), device)


def _cluster_means(user_models: np.ndarray, labels: np.ndarray):
    """(K', d) distinct shared models + K' for label-constant user models."""
    ks = np.unique(labels)
    return np.stack([user_models[labels == k][0] for k in ks]), len(ks)


# ------------------------------------------------------------------ ODCL

@dataclasses.dataclass
class ODCL:
    """Algorithm 1 over any registered admissible clustering algorithm.

    ``ODCL(algorithm="kmeans++", k=10)`` is ODCL-KM++;
    ``ODCL(algorithm="clusterpath")`` the k-free ODCL-CC variant.
    ``options`` go to the algorithm's ``__call__``; ``aggregator`` names
    the step-3 reduction.  Local models that are not a tensor go to
    ``device`` (CUDA unless "cpu")."""
    algorithm: Any = "kmeans++"            # a registered name or instance
    k: Optional[int] = None
    options: dict = dataclasses.field(default_factory=dict)
    assert_separable: bool = False
    aggregator: Any = "mean"
    device: Any = None

    COMM_ROUNDS = 1   # one uplink of local ERMs + one downlink, always

    @property
    def name(self) -> str:
        return f"odcl-{get_algorithm(self.algorithm).name}"

    def fit(self, key, xs, ys, erm: Optional[ERMSolver] = None) -> MethodResult:
        local = _local_models(erm, xs, ys)
        if not isinstance(local, torch.Tensor):
            local = _on(local, resolve_device(self.device))
        res = run_clustering(_generator(key, local.device), local,
                             self.algorithm, k=self.k,
                             assert_separable=self.assert_separable,
                             **self.options)
        cluster_avg, user_models = aggregate(local, res.labels,
                                             aggregator=self.aggregator)
        return MethodResult(user_models=user_models, labels=res.labels,
                            cluster_models=cluster_avg,
                            n_clusters=cluster_avg.shape[0],
                            comm_rounds=self.COMM_ROUNDS,
                            meta=dict(res.meta))


# ------------------------------------------------------------------ IFCA

@dataclasses.dataclass
class IFCA:
    """The iterative baseline: alternating assignment and cluster updates.

    ``init`` is a (k, d) array of initial models or a callable
    ``init(generator, xs, ys) -> (k, d)`` (``None``: N(0, 1) draws);
    ``loss_fn(theta, x, y)`` and ``grad_fn(theta, x, y)`` are the
    per-user objective pieces.  Runs on ``device`` (CUDA unless "cpu")."""
    k: int
    loss_fn: Callable
    grad_fn: Callable
    init: Any = None
    rounds: int = 200
    step_size: float = 0.1
    mode: str = "gradient"
    local_steps: int = 5
    name: str = "ifca"
    device: Any = None

    def _theta0(self, generator, xs, ys) -> torch.Tensor:
        dev = generator.device
        if self.init is None:
            d = int(xs.shape[-1])
            return torch.randn((self.k, d), generator=generator, device=dev)
        init = (self.init(generator, xs, ys) if callable(self.init)
                else self.init)
        return _on(init, dev)

    def fit(self, key, xs, ys, erm: Optional[ERMSolver] = None) -> MethodResult:
        dev = resolve_device(self.device)
        cfg = IFCAConfig(k=self.k, rounds=self.rounds,
                         step_size=self.step_size, mode=self.mode,
                         local_steps=self.local_steps)
        theta0 = self._theta0(_generator(key, dev), xs, ys).to(dev)
        theta, labels, hist = ifca(theta0, _on(xs, dev), _on(ys, dev),
                                   self.loss_fn, self.grad_fn, cfg)
        theta = theta.cpu().numpy()
        labels = labels.cpu().numpy()
        return MethodResult(user_models=theta[labels], labels=labels,
                            cluster_models=theta, n_clusters=self.k,
                            comm_rounds=float(self.rounds),
                            meta={"history": hist.cpu().numpy()})


# -------------------------------------------------------------- baselines

@dataclasses.dataclass
class GlobalERM:
    """Naive averaging of every local ERM, oblivious to heterogeneity."""
    name: str = "global-erm"

    def fit(self, key, xs, ys, erm: Optional[ERMSolver] = None) -> MethodResult:
        local = _host(_local_models(erm, xs, ys))
        user_models = oracles.naive_averaging(local)
        return MethodResult(user_models=user_models,
                            labels=np.zeros(local.shape[0], np.int32),
                            cluster_models=user_models[:1], n_clusters=1,
                            comm_rounds=1, meta={})


@dataclasses.dataclass
class LocalOnly:
    """Every user keeps its own local ERM: zero communication."""
    name: str = "local-only"

    def fit(self, key, xs, ys, erm: Optional[ERMSolver] = None) -> MethodResult:
        local = _host(_local_models(erm, xs, ys))
        m = local.shape[0]
        return MethodResult(user_models=oracles.local_erm(local),
                            labels=np.arange(m, dtype=np.int32),
                            cluster_models=None, n_clusters=m,
                            comm_rounds=0, meta={})


@dataclasses.dataclass
class OracleAveraging:
    """Average local ERMs within the TRUE clusters (knows the labels)."""
    true_labels: np.ndarray = None
    name: str = "oracle-averaging"

    def fit(self, key, xs, ys, erm: Optional[ERMSolver] = None) -> MethodResult:
        local = _host(_local_models(erm, xs, ys))
        labels = np.asarray(self.true_labels)
        user_models = oracles.oracle_averaging(local, labels)
        cluster_models, n_clusters = _cluster_means(user_models, labels)
        return MethodResult(user_models=user_models, labels=labels,
                            cluster_models=cluster_models,
                            n_clusters=n_clusters, comm_rounds=1, meta={})


@dataclasses.dataclass
class ClusterOracle:
    """Centralized training on each true cluster's pooled data.

    ``solve_fn(x, y) -> theta`` is the centralized solver (numpy in, numpy
    or a tensor out); this is the order-optimal target every clustered
    method is measured against."""
    solve_fn: Callable = None
    true_labels: np.ndarray = None
    name: str = "cluster-oracle"

    def fit(self, key, xs, ys, erm: Optional[ERMSolver] = None) -> MethodResult:
        labels = np.asarray(self.true_labels)
        user_models = oracles.cluster_oracle(
            lambda x, y: _host(self.solve_fn(x, y)), xs, ys, labels)
        cluster_models, n_clusters = _cluster_means(user_models, labels)
        return MethodResult(user_models=user_models, labels=labels,
                            cluster_models=cluster_models,
                            n_clusters=n_clusters, comm_rounds=1, meta={})


# ------------------------------------------------------------------ registry

_METHODS: dict[str, type] = {}


def register_method(cls: type, *, name: Optional[str] = None,
                    overwrite: bool = False) -> type:
    """Register a Method class under a name.  Returns it (decorator-safe)."""
    key = name if name is not None else getattr(cls, "name", None)
    if not isinstance(key, str) or not key:
        key = cls.__name__.lower()
    if key in _METHODS and not overwrite:
        raise ValueError(f"federated method {key!r} already registered "
                         "(pass overwrite=True to replace)")
    _METHODS[key] = cls
    return cls


def get_method(name: str) -> type:
    try:
        return _METHODS[name]
    except KeyError:
        raise KeyError(f"unknown federated method {name!r}; "
                       f"registered: {sorted(_METHODS)}") from None


def list_methods() -> tuple[str, ...]:
    return tuple(sorted(_METHODS))


for _cls, _name in ((ODCL, "odcl"), (IFCA, "ifca"),
                    (GlobalERM, "global-erm"), (LocalOnly, "local-only"),
                    (OracleAveraging, "oracle-averaging"),
                    (ClusterOracle, "cluster-oracle")):
    register_method(_cls, name=_name)
del _cls, _name
