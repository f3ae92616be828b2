"""Device clustering registry (the port's subset of
``repro/core/clustering/api.py``): the device result type, the uniform
meta contract, the ``kmeans-device`` Lloyd family with its warm-start
protocol, and the Lloyd-name mapping of ``resolve_device_request``.
The host families, spectral seeding and the convex family come later.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core.engine.device_kmeans import _check_options, device_kmeans


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


def is_device_algorithm(algo) -> bool:
    return callable(getattr(algo, "device_call", None))


@dataclasses.dataclass(frozen=True)
class DeviceLloydFamily:
    """The device Lloyd loop (``engine.device_kmeans``) as the registry's
    ``kmeans-device`` (ODCL-KM, Lemma 2).  ``init`` is an option
    (``kmeans++`` | ``random`` | ``warm``); ``restarts`` keeps the best
    of that many inits."""
    name: str = "kmeans-device"
    requires_k: bool = True

    def device_call(self, generator, points, *, k: Optional[int] = None,
                    iters: int = 100, init: str = "kmeans++",
                    restarts: int = 1, batch_m: Optional[int] = None,
                    aggregator=None, init_centers=None,
                    **_: Any) -> DeviceClusteringResult:
        if k is None:
            raise ValueError(f"{self.name!r} requires k")
        _check_options(batch_m, points.shape[0], aggregator)
        res = device_kmeans(generator, points, k, iters=iters, init=init,
                            restarts=restarts, init_centers=init_centers)
        n_clusters = torch.sum(
            torch.bincount(res.labels.long(), minlength=k) > 0)
        return DeviceClusteringResult(
            labels=res.labels, centers=res.centers,
            meta=device_meta(
                inertia=res.inertia, n_iter=res.n_iter,
                restarts=1 if init == "warm" else restarts,
                n_clusters=n_clusters, restart_spread=res.restart_spread,
                device=points.device))

    def warm_state(self, res: DeviceClusteringResult):
        return res.centers

    def device_warm_call(self, generator, points, warm, *,
                         k: Optional[int] = None,
                         **options: Any) -> DeviceClusteringResult:
        options = {**options, "init": "warm", "restarts": 1}
        return self.device_call(generator, points, k=k, init_centers=warm,
                                **options)


# ------------------------------------------------------------- registry

_REGISTRY: dict = {}


def register_algorithm(algo, *, name: Optional[str] = None,
                       overwrite: bool = False):
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
LLOYD_DEVICE_INIT = {"kmeans": "random", "kmeans++": "kmeans++"}


def resolve_device_request(algorithm, options: Optional[dict] = None):
    """Map a request onto a device algorithm: device names pass through,
    the Lloyd-family names map onto ``kmeans-device`` with their init.
    Returns ``(algorithm, options)``; anything else raises."""
    if isinstance(algorithm, str) and algorithm in LLOYD_DEVICE_INIT:
        return "kmeans-device", {"init": LLOYD_DEVICE_INIT[algorithm],
                                 **(options or {})}
    algo = get_algorithm(algorithm)
    if not is_device_algorithm(algo):
        raise ValueError(f"{getattr(algo, 'name', algo)!r} is not a device "
                         "clustering algorithm")
    return algorithm, options


register_algorithm(DeviceLloydFamily())
