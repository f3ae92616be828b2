"""The admissible-clustering registry, the set C of ODCL-C (the port of
``repro/core/clustering/api.py``): the host and device result types, the
uniform meta contract, and the paper's families with the Lemma-1/2
admissibility margin of each:

  * the Lloyd family: host ``kmeans`` (random init), ``kmeans++`` and
    ``spectral`` (``clustering/kmeans.py``), and ``kmeans-device``
    (``engine/device_kmeans.py``: the init an option, restarts, minibatch
    and robust center updates, a warm-start protocol);
  * gradient clustering: ``gradient`` and ``gradient-device``;
  * the convex family: ``convex-device``, ``clusterpath-device`` and their
    host twins ``convex``, ``clusterpath``.

Every registered algorithm is a ``ClusteringAlgorithm``; the device
families are ``DeviceClusteringAlgorithm`` too.  The registry takes any
object with those members.  ``resolve_device_request`` /
``resolve_host_request`` map a request onto the engine that runs it, as
in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core.clustering.admissible import (
    alpha_convex_clustering,
    alpha_kmeans,
    separability_alpha,
)
from repro_torch.core.clustering.convex import (
    clusterpath,
    convex_clustering,
    lambda_interval,
)
from repro_torch.core.clustering.gradient import gradient_clustering
from repro_torch.core.clustering.kmeans import kmeans
from repro_torch.core.engine.aggregators import get_aggregator
from repro_torch.core.engine.device_convex import (
    device_clusterpath,
    device_convex_cluster,
)
from repro_torch.core.engine.device_kmeans import device_kmeans
from repro_torch.device import resolve_device
from repro_torch.sharding.clients import shard_of


@dataclasses.dataclass(frozen=True)
class ClusteringResult:
    """Host output of a clustering algorithm's ``__call__``."""
    labels: np.ndarray        # (m,) int cluster id per point (host)
    centers: np.ndarray       # (K, d) cluster representatives (host)
    n_clusters: int           # number of distinct recovered clusters
    meta: dict                # algorithm-specific diagnostics


class DeviceClusteringResult(NamedTuple):
    """Device-resident clustering output (tensors; meta maps names to
    0-d tensors)."""
    labels: torch.Tensor      # (m,) int32 cluster id per point
    centers: torch.Tensor     # (k, d) cluster representatives
    meta: dict                # the DEVICE_META_KEYS schema
    aux: Any = None           # warm-start state beyond the centers


# every device algorithm reports exactly these keys
DEVICE_META_KEYS = ("inertia", "n_iter", "restarts", "n_clusters", "lam",
                    "restart_spread")
_COUNT_KEYS = ("n_iter", "restarts", "n_clusters")


def device_meta(*, inertia, n_iter, n_clusters, restarts=1, lam=None,
                restart_spread=None, device=None) -> dict:
    """The uniform meta dict: fields a family has no notion of (``lam``
    for Lloyd) are NaN, which ``meta_to_host`` turns back into ``None``."""
    def scalar(v, dtype):
        if v is None:
            v = float("nan")
        return torch.as_tensor(v, dtype=dtype, device=device)

    return {
        "inertia": scalar(inertia, torch.float32),
        "n_iter": scalar(n_iter, torch.int32),
        "restarts": scalar(restarts, torch.int32),
        "n_clusters": scalar(n_clusters, torch.int32),
        "lam": scalar(lam, torch.float32),
        "restart_spread": scalar(restart_spread, torch.float32),
    }


def meta_to_host(meta: dict) -> dict:
    """Device meta -> host meta in one transfer: ints for the count keys,
    floats elsewhere, NaN sentinels back to ``None``."""
    names = list(meta)
    vals = torch.stack([meta[n].to(torch.float64).reshape(())
                        for n in names]).cpu().tolist()
    out = {}
    for name, x in zip(names, vals):
        if name in _COUNT_KEYS:
            out[name] = int(x)
        elif name in ("lam", "restart_spread") and x != x:
            out[name] = None
        else:
            out[name] = float(x)
    return out


@runtime_checkable
class ClusteringAlgorithm(Protocol):
    """An admissible algorithm of C (server step 2 of Algorithm 1): a
    ``torch.Generator`` and (m, d) points in, a ``ClusteringResult`` out,
    and the Lemma-1/2 margin ``admissibility_alpha``."""
    name: str
    requires_k: bool

    def __call__(self, generator, points, *, k: Optional[int] = None,
                 **options: Any) -> ClusteringResult: ...

    def admissibility_alpha(self, m: int, c_min: int) -> float: ...


@runtime_checkable
class DeviceClusteringAlgorithm(ClusteringAlgorithm, Protocol):
    """The device-capable variant (the aggregation engine): ``device_call``
    takes an (m, d) float32 tensor and returns a ``DeviceClusteringResult``
    whose fields stay on the points' device.  It keeps the host
    ``__call__``, so every host consumer of the registry can use it."""

    def device_call(self, generator, points, *, k: Optional[int] = None,
                    **options: Any) -> DeviceClusteringResult: ...


def is_device_algorithm(algo) -> bool:
    return callable(getattr(algo, "device_call", None))


def separability_of(points, result: "ClusteringResult") -> float:
    """Achieved margin of condition (4) for ``result`` on ``points``."""
    return separability_alpha(points, result.labels)


def _host_points(points, device=None) -> torch.Tensor:
    """A tensor stays on its device; anything else goes to ``device``
    (CUDA unless "cpu")."""
    if not isinstance(points, torch.Tensor):
        points = torch.as_tensor(np.asarray(points, np.float32)).to(
            resolve_device(device))
    return points.to(torch.float32)


def _whole(points, shard):
    """The families without a sharded form cluster every row on every
    rank: under a mesh the points are gathered first."""
    return shard_of(points, shard).gather(points)


def _n_clusters(labels, k: int) -> torch.Tensor:
    return torch.sum(torch.bincount(labels.long(), minlength=k) > 0)


@dataclasses.dataclass(frozen=True)
class LloydFamily:
    """kmeans / kmeans++ / spectral: the host Lloyd loop
    (``clustering.kmeans``), one registry name per init (ODCL-KM,
    Lemma 2).  Runs on the points' device (a tensor), else on CUDA."""
    name: str
    init: str
    requires_k: bool = True

    def __call__(self, generator, points, *, k: Optional[int] = None,
                 iters: int = 100, sampler=None, device=None,
                 **_: Any) -> ClusteringResult:
        if k is None:
            raise ValueError(f"{self.name!r} requires k")
        res = kmeans(generator, _host_points(points, device), k, iters=iters,
                     init=self.init, sampler=sampler)
        return _as_result(res.labels.cpu().numpy(), res.centers.cpu().numpy(),
                          {"inertia": float(res.inertia),
                           "n_iter": int(res.n_iter)})

    def admissibility_alpha(self, m: int, c_min: int) -> float:
        return alpha_kmeans(m, c_min)


@dataclasses.dataclass(frozen=True)
class DeviceLloydFamily:
    """The device Lloyd loop (``engine.device_kmeans``) as the registry's
    ``kmeans-device`` (ODCL-KM, Lemma 2).  ``init`` is an option
    (``kmeans++`` | ``spectral`` | ``random`` | ``warm``); ``restarts``
    keeps the best of that many inits; ``batch_m`` switches to minibatch
    updates; ``aggregator`` (a registry name or instance other than
    ``mean``) makes the center update robust.  ``shard`` (a
    ``sharding.clients.RowShard``) runs the loop on this rank's rows;
    the labels come back for every row."""
    name: str = "kmeans-device"
    requires_k: bool = True

    @staticmethod
    def _resolve_aggregator(aggregator):
        """None / 'mean' keep the kernel's accumulator update; anything
        else resolves through the aggregator registry."""
        if aggregator is None:
            return None
        agg = get_aggregator(aggregator)
        return None if agg.name == "mean" else agg

    def device_call(self, generator, points, *, k: Optional[int] = None,
                    iters: int = 100, init: str = "kmeans++",
                    restarts: int = 1, batch_m: Optional[int] = None,
                    aggregator=None, init_centers=None, sampler=None,
                    shard=None, **_: Any) -> DeviceClusteringResult:
        if k is None:
            raise ValueError(f"{self.name!r} requires k")
        res = device_kmeans(generator, points, k, iters=iters, init=init,
                            restarts=restarts, batch_m=batch_m,
                            aggregator=self._resolve_aggregator(aggregator),
                            init_centers=init_centers, sampler=sampler,
                            shard=shard)
        # the effective restart count: full-batch spectral seeding and
        # warm starts are deterministic, so device_kmeans runs them once
        full_batch = (batch_m is None
                      or batch_m >= shard_of(points, shard).total)
        eff_restarts = (1 if (init in ("spectral", "warm") and full_batch)
                        else restarts)
        return DeviceClusteringResult(
            labels=res.labels, centers=res.centers,
            meta=device_meta(
                inertia=res.inertia, n_iter=res.n_iter,
                restarts=eff_restarts, n_clusters=_n_clusters(res.labels, k),
                restart_spread=res.restart_spread, device=points.device))

    def warm_state(self, res: DeviceClusteringResult):
        return res.centers

    def device_warm_call(self, generator, points, warm, *,
                         k: Optional[int] = None,
                         **options: Any) -> DeviceClusteringResult:
        # the warm state supersedes any init_centers of the finalize
        # being replayed (a warm-started first finalize, as the parity
        # tests run it)
        options = {**options, "init": "warm", "restarts": 1}
        options.pop("init_centers", None)
        return self.device_call(generator, points, k=k, init_centers=warm,
                                **options)

    def __call__(self, generator, points, *, k: Optional[int] = None,
                 **options: Any) -> ClusteringResult:
        return _host_view(self.device_call(
            generator, torch.as_tensor(points).to(torch.float32), k=k,
            **options))

    def admissibility_alpha(self, m: int, c_min: int) -> float:
        return alpha_kmeans(m, c_min)


@dataclasses.dataclass(frozen=True)
class GradientClustering:
    """Gradient clustering [21], K-means type, so Lemma 2 applies.  Runs
    on the points' device (a tensor), else on CUDA."""
    name: str = "gradient"
    requires_k: bool = True

    def __call__(self, generator, points, *, k: Optional[int] = None,
                 iters: int = 100, alpha: float = 0.5, device=None,
                 **_: Any) -> ClusteringResult:
        if k is None:
            raise ValueError("gradient clustering requires k")
        res = gradient_clustering(generator, _host_points(points, device), k,
                                  alpha=alpha, iters=iters)
        return _as_result(res.labels.cpu().numpy(), res.centers.cpu().numpy(),
                          {"inertia": float(res.inertia)})

    def admissibility_alpha(self, m: int, c_min: int) -> float:
        return alpha_kmeans(m, c_min)


@dataclasses.dataclass(frozen=True)
class DeviceGradientClustering:
    """Device twin of ``"gradient"``: the damped center loop on the
    points' device, reported through the device meta contract."""
    name: str = "gradient-device"
    requires_k: bool = True

    def device_call(self, generator, points, *, k: Optional[int] = None,
                    iters: int = 100, alpha: float = 0.5, shard=None,
                    **_: Any) -> DeviceClusteringResult:
        if k is None:
            raise ValueError("gradient clustering requires k")
        points = _whole(points, shard)
        res = gradient_clustering(generator, points.to(torch.float32), k,
                                  alpha=alpha, iters=iters)
        return DeviceClusteringResult(
            labels=res.labels, centers=res.centers,
            meta=device_meta(inertia=res.inertia, n_iter=res.n_iter,
                             n_clusters=_n_clusters(res.labels, k),
                             device=points.device))

    def __call__(self, generator, points, *, k: Optional[int] = None,
                 **options: Any) -> ClusteringResult:
        return _host_view(self.device_call(
            generator, torch.as_tensor(points).to(torch.float32), k=k,
            **options))

    def admissibility_alpha(self, m: int, c_min: int) -> float:
        return alpha_kmeans(m, c_min)


def _as_result(labels, centers, meta) -> ClusteringResult:
    # compact label ids (root ids, empty clusters) so n_clusters counts
    # only the recovered clusters
    uniq, labels = np.unique(np.asarray(labels), return_inverse=True)
    centers = np.asarray(centers)
    if centers.shape[0] > len(uniq):
        centers = centers[uniq]
    return ClusteringResult(labels=labels.astype(np.int32), centers=centers,
                            n_clusters=len(uniq), meta=dict(meta))


def _device_convex_result(points, res) -> DeviceClusteringResult:
    # inertia against the root-indexed fusion centers puts the convex
    # family on the Lloyd family's quality scalar; n_iter is the AMA's
    # iterations to converge
    inertia = torch.sum((points - res.centers[res.labels.long()]) ** 2)
    return DeviceClusteringResult(
        labels=res.labels, centers=res.centers,
        meta=device_meta(inertia=inertia, n_iter=res.n_iter,
                         n_clusters=res.n_clusters, lam=res.lam,
                         device=points.device),
        aux=res.nu)


def _host_view(res: DeviceClusteringResult) -> ClusteringResult:
    return _as_result(res.labels.cpu().numpy(), res.centers.cpu().numpy(),
                      meta_to_host(res.meta))


@dataclasses.dataclass(frozen=True)
class DeviceConvexClustering:
    """Device twin of ``"convex"`` (``engine.device_convex``): the AMA
    fixed point, fusion-graph components and root-indexed cluster means,
    all on the points' device.  ``edges`` names the fusion graph
    (``complete`` | ``knn`` | ``knn-approx``, ``knn_k`` neighbours)."""
    name: str = "convex-device"
    requires_k: bool = False
    # the warm state is the AMA dual, one row per edge slot: valid only
    # while the point count (hence the slot layout) is unchanged
    warm_requires_same_count: bool = True

    def device_call(self, generator, points, *, k: Optional[int] = None,
                    lam: Optional[float] = None, iters: int = 400,
                    weights=None, merge_tol=None, edges="complete",
                    knn_k: int = 8, warm_nu=None, shard=None,
                    **_: Any) -> DeviceClusteringResult:
        del k
        points = _whole(points, shard)
        return _device_convex_result(points, device_convex_cluster(
            generator, points, lam=lam, iters=iters, weights=weights,
            merge_tol=merge_tol, edges=edges, knn_k=knn_k, warm_nu=warm_nu))

    def warm_state(self, res: DeviceClusteringResult):
        return res.aux

    def device_warm_call(self, generator, points, warm, *,
                         k: Optional[int] = None,
                         **options: Any) -> DeviceClusteringResult:
        return self.device_call(generator, points, k=k, warm_nu=warm,
                                **options)

    def __call__(self, generator, points, *, k: Optional[int] = None,
                 **options: Any) -> ClusteringResult:
        return _host_view(self.device_call(
            generator, torch.as_tensor(points).to(torch.float32), k=k,
            **options))

    def admissibility_alpha(self, m: int, c_min: int) -> float:
        return alpha_convex_clustering(m, c_min)


@dataclasses.dataclass(frozen=True)
class DeviceClusterpath:
    """Device twin of ``"clusterpath"``: the lambda ladder advances as one
    batched AMA solve (the batched group-prox kernel) and the plurality
    plateau picks the clustering; K-free.  ``edges``/``knn_k`` as for
    ``"convex-device"``."""
    name: str = "clusterpath-device"
    requires_k: bool = False

    def device_call(self, generator, points, *, k: Optional[int] = None,
                    n_lambdas: int = 10, iters: int = 300, merge_tol=None,
                    edges="complete", knn_k: int = 8, shard=None,
                    **_: Any) -> DeviceClusteringResult:
        del k
        points = _whole(points, shard)
        return _device_convex_result(points, device_clusterpath(
            generator, points, n_lambdas=n_lambdas, iters=iters,
            merge_tol=merge_tol, edges=edges, knn_k=knn_k))

    def __call__(self, generator, points, *, k: Optional[int] = None,
                 **options: Any) -> ClusteringResult:
        return _host_view(self.device_call(
            generator, torch.as_tensor(points).to(torch.float32), k=k,
            **options))

    def admissibility_alpha(self, m: int, c_min: int) -> float:
        return alpha_convex_clustering(m, c_min)


@dataclasses.dataclass(frozen=True)
class ConvexClustering:
    """Sum-of-norms clustering at a fixed lambda with host cluster
    extraction (ODCL-CC).  ``lam=None`` takes the upper recovery bound of
    the all-singletons clustering (paper E.1).  Runs on the points'
    device (a tensor), else on CUDA."""
    name: str = "convex"
    requires_k: bool = False

    def __call__(self, generator, points, *, k: Optional[int] = None,
                 lam: Optional[float] = None, iters: int = 400,
                 weights=None, **_: Any) -> ClusteringResult:
        if lam is None:
            m = points.shape[0]
            lo, hi = lambda_interval(points, np.arange(m))
            lam = hi if np.isfinite(hi) else lo + 1e-3
        res = convex_clustering(points, float(lam), iters=iters,
                                weights=weights)
        return _as_result(res.labels, res.centers,
                          {"lam": res.lam, "n_clusters": res.n_clusters})

    def admissibility_alpha(self, m: int, c_min: int) -> float:
        return alpha_convex_clustering(m, c_min)


@dataclasses.dataclass(frozen=True)
class Clusterpath:
    """Lambda-sweep convex clustering (Appendix B.3/E.3), no k needed."""
    name: str = "clusterpath"
    requires_k: bool = False

    def __call__(self, generator, points, *, k: Optional[int] = None,
                 n_lambdas: int = 10, iters: int = 400,
                 **_: Any) -> ClusteringResult:
        best, _ = clusterpath(points, n_lambdas=n_lambdas, iters=iters)
        return _as_result(best.labels, best.centers,
                          {"lam": best.lam, "n_clusters": best.n_clusters})

    def admissibility_alpha(self, m: int, c_min: int) -> float:
        return alpha_convex_clustering(m, c_min)


# ------------------------------------------------------------- registry

_REGISTRY: dict = {}


def register_algorithm(algo: ClusteringAlgorithm, *,
                       name: Optional[str] = None,
                       overwrite: bool = False) -> ClusteringAlgorithm:
    key = name if name is not None else algo.name
    if key in _REGISTRY and not overwrite:
        raise ValueError(f"algorithm {key!r} already registered "
                         "(pass overwrite=True to replace)")
    _REGISTRY[key] = algo
    return algo


def unregister_algorithm(name: str) -> None:
    _REGISTRY.pop(name, None)


def get_algorithm(name):
    """Resolve a name (or pass through an instance)."""
    if not isinstance(name, str):
        return name
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown algorithm {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def list_algorithms() -> tuple:
    return tuple(sorted(_REGISTRY))


# host Lloyd-family names and the kmeans-device init that reproduces them
LLOYD_DEVICE_INIT = {"kmeans": "random", "kmeans++": "kmeans++",
                     "spectral": "spectral"}


def device_twin(algo):
    """The registered ``"<name>-device"`` twin of a host algorithm (the
    session runs ``"convex"`` as ``"convex-device"``), or ``None``."""
    name = getattr(algo, "name", None)
    if not isinstance(name, str) or name.endswith("-device"):
        return None
    twin = _REGISTRY.get(f"{name}-device")
    return twin if twin is not None and is_device_algorithm(twin) else None


def resolve_device_request(algorithm, options: Optional[dict] = None, *,
                           strict: bool = True):
    """Map a request onto something the device engine runs: device names
    and names with a registered ``"-device"`` twin pass through (the
    caller upgrades a twin), the Lloyd-family names map onto
    ``kmeans-device`` with their init (the mapping outranks the twin, so
    ``kmeans`` keeps its random init).  Returns ``(algorithm,
    options)``; any other name raises when ``strict`` (engine='device')
    and passes through when not (engine='auto', the host path)."""
    algo = get_algorithm(algorithm)
    if is_device_algorithm(algo):
        return algorithm, options
    name = getattr(algo, "name", algorithm)
    if name in LLOYD_DEVICE_INIT:
        return "kmeans-device", {"init": LLOYD_DEVICE_INIT[name],
                                 **(options or {})}
    if device_twin(algo) is not None:
        return algorithm, options
    if strict:
        raise ValueError(
            f"engine='device' needs a device-capable algorithm (e.g. "
            f"kmeans-device), a Lloyd-family name, or a name with a "
            f"registered '-device' twin, not {name!r}")
    return algorithm, options


def resolve_host_request(algorithm, options: Optional[dict] = None):
    """Map a request onto the host clustering path, the mirror of
    ``resolve_device_request``: host names pass through, ``kmeans-device``
    maps back to the host Lloyd name of its ``init`` option, other
    ``"<name>-device"`` names to their registered ``"<name>"``.  A
    twin-less device name, or a device-only option such as
    ``init='warm'``, raises ``ValueError``.  Returns ``(algorithm,
    options)``."""
    algo = get_algorithm(algorithm)
    name = getattr(algo, "name", algorithm)
    if not (isinstance(name, str) and name.endswith("-device")):
        return algorithm, options
    opts = dict(options or {})
    if name == "kmeans-device":
        init = opts.pop("init", "kmeans++")
        host = {v: n for n, v in LLOYD_DEVICE_INIT.items()}.get(init)
        if host is None:
            raise ValueError(
                f"engine='host' cannot run kmeans-device init={init!r}; "
                f"host Lloyd inits: {sorted(LLOYD_DEVICE_INIT.values())}")
        return host, (opts or None)
    base = name[: -len("-device")]
    if base in _REGISTRY:
        return base, options
    raise ValueError(
        f"engine='host' cannot run device-only algorithm {name!r}: no "
        f"registered host base {base!r}")


for _algo in (
    LloydFamily(name="kmeans", init="random"),
    LloydFamily(name="kmeans++", init="kmeans++"),
    LloydFamily(name="spectral", init="spectral"),
    DeviceLloydFamily(),
    GradientClustering(),
    DeviceGradientClustering(),
    ConvexClustering(),
    Clusterpath(),
    DeviceConvexClustering(),
    DeviceClusterpath(),
):
    register_algorithm(_algo)
del _algo
