"""The federation's stacked state, the one-shot round over it, and its
accounting (the port's counterparts of ``FederatedState`` and
``one_shot_aggregate`` in ``repro/core/federated.py``, and of
``cluster_agreement`` / the comm-bytes rule in
``repro/core/federated_methods.py``)."""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.utils import tree_leaves, tree_map, tree_size


class FederatedState(NamedTuple):
    params: dict                 # every leaf has leading client axis C
    opt_state: Optional[dict]    # AdamW state after a host round, else None
    n_clients: int
    step: int = 0


def one_shot_aggregate(state: FederatedState, *, algorithm="kmeans++", k: Optional[int] = None,
                       algo_options: Optional[dict] = None,
                       assert_separable: bool = False,
                       sketch_dim: int = 256, seed: int = 0,
                       cluster_seed: Optional[int] = None,
                       engine: str = "auto", aggregator="mean",
                       projection: Optional[torch.Tensor] = None,
                       return_sketches: bool = False, device=None):
    """The single communication round of Algorithm 1 over a stacked
    parameter tree.  Returns ``(new_state, labels, info)``.

    ``engine``: ``"auto"`` runs the fused round
    (``engine.one_shot_aggregate_device``) when the algorithm is
    device-capable or has a registered ``"<name>-device"`` twin, the host
    path otherwise; ``"host"`` / ``"device"`` force one.  The host path
    sketches every client with the same JL projection (``seed``, or
    ``projection=``), clusters through ``run_clustering`` (with the
    Definition-1 margins, ``assert_separable`` among them) and reduces
    the parameters per cluster through ``aggregator``, on the parameters'
    device (CUDA unless ``device="cpu"``).  The reference's ``cfg``
    (the router-invariant sketch of MoE models) comes with
    ``models/moe.py``."""
    from repro_torch.core.clustering.api import (
        device_twin, get_algorithm, is_device_algorithm)
    from repro_torch.core.engine.aggregators import cluster_aggregate_tree
    from repro_torch.core.odcl import run_clustering
    from repro_torch.core.sketch import (
        jl_projection, make_generator, sketch_stacked)
    from repro_torch.device import resolve_device
    from repro_torch.optim import adamw_init

    if engine not in ("auto", "host", "device"):
        raise ValueError(f"engine must be auto|host|device, got {engine!r}")
    if cluster_seed is None:
        cluster_seed = seed
    algo = get_algorithm(algorithm)
    dev_algo = algo if is_device_algorithm(algo) else device_twin(algo)
    if engine == "device" and dev_algo is None:
        raise ValueError(
            f"engine='device' needs a device-capable algorithm, but "
            f"{algo.name!r} is host-only with no registered "
            f"'{algo.name}-device' twin (try 'kmeans-device')")
    use_device = engine != "host" and dev_algo is not None
    if use_device and assert_separable:
        if engine == "device":
            raise ValueError("assert_separable requires engine='host' (the "
                             "Definition-1 margin is computed host-side)")
        use_device = False
    if use_device:
        from repro_torch.core.engine.aggregate import (
            one_shot_aggregate_device)

        return one_shot_aggregate_device(
            state, algorithm=dev_algo, k=k, algo_options=algo_options,
            sketch_dim=sketch_dim, seed=seed, cluster_seed=cluster_seed,
            aggregator=aggregator, projection=projection,
            return_sketches=return_sketches, device=device)

    dev = resolve_device(device)
    params = tree_map(lambda l: torch.as_tensor(l).to(dev), state.params)
    if projection is None:
        projection = jl_projection(tree_size(params) // state.n_clients,
                                   sketch_dim, seed=seed, device=dev)
    sketches = sketch_stacked(params, projection.to(dev, torch.float32))
    result = run_clustering(make_generator(cluster_seed, dev), sketches,
                            algo, k=k, assert_separable=assert_separable,
                            **(algo_options or {}))
    labels = result.labels
    n_clusters = int(labels.max()) + 1
    labels_t = torch.as_tensor(labels).to(dev)
    onehot = torch.nn.functional.one_hot(labels_t.long(), n_clusters).to(
        torch.float32)
    new_params = cluster_aggregate_tree(params, labels_t, onehot,
                                        torch.sum(onehot, dim=0), aggregator)
    new_state = FederatedState(
        params=new_params, opt_state=adamw_init(new_params, state.n_clients),
        n_clients=state.n_clients, step=state.step)
    info = {"n_clusters": n_clusters, "meta": result.meta, "engine": "host"}
    if return_sketches:
        info["sketches"] = sketches.cpu().numpy()
    return new_state, labels, info


def params_bytes_per_client(state: FederatedState) -> int:
    """Bytes of ONE client's model (the unit of comm accounting)."""
    c = max(1, state.n_clients)
    return sum(l.numel() // c * l.element_size()
               for l in tree_leaves(state.params))


def sketch_round_bytes(n_clients: int, sketch_dim: int,
                       bytes_per: int) -> float:
    """Protocol bytes of one sketch-clustered round: uplink = the sketch
    plus the full model, downlink = the cluster model."""
    return float(n_clients * (sketch_dim * 4 + 2 * bytes_per))


def cluster_agreement(pred, true) -> float:
    """Purity of ``pred`` against the hidden clustering ``true`` (integer
    ids): each predicted cluster votes for its majority truth."""
    pred, true = np.asarray(pred), np.asarray(true)
    total = 0
    for c in np.unique(pred):
        total += int(np.bincount(true[pred == c]).max())
    return total / len(true)
