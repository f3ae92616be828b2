"""Algorithm 1 over a federation of deep models (the port of
``repro/core/federated.py``): the stacked state, the local phase, the
one-shot round and its accounting (also ``cluster_agreement`` and the
comm-bytes rule of ``repro/core/federated_methods.py``).

Parameters carry a leading client axis C on every leaf.  The local
phase (``launch.steps.make_local_train_step``) runs each client's step
on views of its slices, with no cross-client work; the round sketches
every client's parameters (streamed JL projection), clusters the
(C, sketch_dim) matrix through the admissible registry and averages the
full parameters within each recovered cluster.

Training advances a state's tensors in place: ``local_training`` and the
round's fresh AdamW moments reuse the buffers of the state they are
given (at qwen2-0.5b, C = 8, the fp32 moments alone take 32 GB).

The client axis may be sharded over a mesh, as the reference's
federation on the ``data`` axis (``init_federation(mesh=)`` places it;
``sharding/clients.py``): every leaf, moment and per-client step is a
``Shard(0)`` DTensor and rank r holds clients ``[r C / R, (r + 1) C /
R)``.  Each rank then trains, evaluates and sketches its own clients;
the only cross-rank traffic is the round's (its gathered sketches or
all-reduced sums) and the (C,) per-client losses gathered for the
caller, so every rank returns what the unmeshed call returns.
"""
from __future__ import annotations

from typing import Iterator, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.utils import tree_leaves, tree_map


class FederatedState(NamedTuple):
    params: dict                 # every leaf has leading client axis C
    opt_state: Optional[dict]    # stacked AdamW state (None: not built)
    n_clients: int
    step: int = 0


def init_federation(key, cfg, n_clients: int, same_init: bool = True,
                    device=None, mesh=None) -> FederatedState:
    """Stacked per-client parameters (the reference's tree layout) and
    AdamW moments of zeros, on ``device`` (CUDA unless "cpu").

    ``key``: an int seed or a ``torch.Generator``.  An int seeds a CPU
    generator and the draws move to ``device``, so one seed gives one
    federation on the card and the CPU (as the reference's threefry keys
    give it on any backend).  ``same_init=True`` starts every client from
    one init (the common FL setting); False draws C independent inits
    from the generator in turn (the paper's local ERMs need no shared
    init, Remark 3).

    ``mesh`` (the port's own; the reference places a federation
    afterwards with ``jax.device_put``): the client axis sharded over
    the mesh's one dim.  Each rank builds only its own clients'
    rows, their moments and steps, as ``Shard(0)`` DTensors; every rank
    draws every independent init in turn and keeps its own, so each
    client's values equal the unmeshed federation's."""
    from repro_torch.device import resolve_device
    from repro_torch.models.transformer import init_tree
    from repro_torch.optim import adamw_init
    from repro_torch.sharding.clients import client_axis_of

    dev = resolve_device(device)
    axis = client_axis_of(mesh)
    lo, hi = axis.owned(n_clients)
    gen = (key if isinstance(key, torch.Generator)
           else torch.Generator().manual_seed(int(key)))
    if same_init:
        p0 = init_tree(cfg, generator=gen, device=dev)
        params = tree_map(
            lambda l: l[None].expand((hi - lo,) + tuple(l.shape)).clone(),
            p0)
    else:
        inits = []
        for c in range(n_clients):      # every draw, in turn
            tree = init_tree(cfg, generator=gen, device=dev)
            if lo <= c < hi:
                inits.append(tree)
        params = tree_map(lambda *ls: torch.stack(ls), *inits)
    params = axis.place(params, n_clients)
    return FederatedState(params=params,
                          opt_state=adamw_init(params, n_clients),
                          n_clients=n_clients)


def local_training(state: FederatedState, cfg, batches: Iterator,
                   steps: int, opt_cfg=None,
                   remat: str = "none") -> tuple:
    """The local-ERM phase: ``steps`` AdamW steps per client, in place on
    the state's tensors.  ``batches`` yields dicts of (C, b, s) arrays.
    Returns (state advanced by ``steps``, [(C,) losses as numpy]).  Each
    step's time, to its losses on the host, feeds the
    ``fed.local_step.ms`` histogram.  On a ``Shard(0)`` state each rank
    steps its own clients and every rank gets every client's losses."""
    import time

    from repro_torch import obs
    from repro_torch.launch.steps import make_local_train_step
    from repro_torch.optim import adamw_init
    from repro_torch.sharding.clients import tree_axis

    local_step = make_local_train_step(cfg, opt_cfg, remat=remat)
    axis = tree_axis(state.params)
    params = state.params
    opt_state = (state.opt_state if state.opt_state is not None
                 else adamw_init(params, state.n_clients))
    losses = []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss, params, opt_state = local_step(params, opt_state,
                                             next(batches))
        losses.append(axis.gather_clients(loss, state.n_clients)
                      .cpu().numpy())
        obs.observe("fed.local_step.ms", (time.perf_counter() - t0) * 1e3)
    return FederatedState(params=params, opt_state=opt_state,
                          n_clients=state.n_clients,
                          step=state.step + steps), losses


def _round_opt_state(state: FederatedState, params) -> Optional[dict]:
    """The AdamW state a round returns: ``None`` when ``state`` has its
    own moments, a fresh ``adamw_init`` otherwise."""
    from repro_torch.optim import adamw_init

    if state.opt_state is not None:
        return None
    return adamw_init(params, state.n_clients)


def _router_invariant_filter(path: str, leaf) -> bool:
    """MoE permutation-robust sketch: drop the per-expert tensors, keep
    the dense path and the router ("/"-joined key path)."""
    return not (("moe" in path) and ("w_in" in path or "w_out" in path))


def _leaf_filter_for(cfg):
    return (_router_invariant_filter
            if cfg is not None and getattr(cfg, "is_moe", False) else None)


def cluster_mean_tree(params, onehot, counts):
    """Step 3 alone: the (K', ...) per-cluster means of a stacked tree
    (``onehot`` (C, K'), ``counts`` (K'); the mean aggregator's
    ``cluster_reduce_tree``, so an empty cluster's mean is 0 where the
    reference divides 0 by 0)."""
    from repro_torch.core.engine.aggregators import cluster_reduce_tree

    return cluster_reduce_tree(params, None, onehot, counts, "mean")


def cluster_average_tree(params, onehot, counts):
    """Steps 3-4: every leaf's per-cluster mean, gathered back per client
    as the reference's ``onehot @ means`` (``counts`` clamped >= 1 by the
    caller): a row whose one-hot sums to 0 gets zeros, a soft row the
    product, a one-hot row its cluster's mean."""
    from repro_torch.core.engine.aggregators import cluster_aggregate_tree

    return cluster_aggregate_tree(params, None, onehot, counts, "mean")


def one_shot_aggregate(state: FederatedState, cfg=None, *,
                       algorithm="kmeans++", k: Optional[int] = None,
                       algo_options: Optional[dict] = None,
                       assert_separable: bool = False,
                       sketch_dim: int = 256, seed: int = 0,
                       cluster_seed: Optional[int] = None,
                       engine: str = "auto", aggregator="mean",
                       projection=None, mesh=None, client_axis: str = "data",
                       return_sketches: bool = False, device=None):
    """The single communication round of Algorithm 1 over a stacked
    parameter tree.  Returns ``(new_state, labels, info)``.

    ``cfg`` (the clients' ``ModelConfig``, or ``None`` for shallow
    models) picks the router-invariant sketch of an MoE model.
    ``engine``: ``"auto"`` runs the fused round
    (``engine.one_shot_aggregate_device``) when the algorithm is
    device-capable or has a registered ``"<name>-device"`` twin, the host
    path otherwise; ``"host"`` / ``"device"`` force one.  The host path
    sketches every client with the same JL projection (drawn from
    ``seed`` block by block, or ``projection=``), clusters through
    ``run_clustering`` (with the Definition-1 margins, ``assert_separable``
    among them) and reduces the parameters per cluster through
    ``aggregator``, on the parameters' device (CUDA unless
    ``device="cpu"``).  The given state is not changed.  The new state
    carries fresh AdamW moments (the reference's ``adamw_init``) when the
    given state has none, else ``None``: the moments' owner resets its
    own (``adamw_reset_``), since a second set takes 8 bytes a parameter
    (32 GB at qwen2-0.5b with 8 clients).

    ``mesh`` / ``client_axis``: the client axis sharded over that mesh
    dim; without them, the mesh a ``Shard(0)`` state lies on.  The fused
    round runs per shard (``one_shot_aggregate_device``); on the host
    path each rank sketches its own clients, the (C, sketch_dim) matrix
    is gathered and ``run_clustering`` runs on it on every rank from the
    same seed, then the mean phase all-reduces per-cluster sums and each
    rank writes its own clients' rows (``Shard(0)`` DTensors)."""
    from repro_torch.core.clustering.api import (
        device_twin, get_algorithm, is_device_algorithm)
    from repro_torch.core.engine.aggregate import _average
    from repro_torch.core.odcl import run_clustering
    from repro_torch.core.sketch import make_generator, sketch_stacked
    from repro_torch.device import resolve_device
    from repro_torch.sharding.clients import client_axis_of, tree_axis

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
    axis = (client_axis_of(mesh, client_axis) if mesh is not None
            else tree_axis(state.params))
    if use_device:
        from repro_torch.core.engine.aggregate import (
            one_shot_aggregate_device)

        new_state, labels, info = one_shot_aggregate_device(
            state, cfg, algorithm=dev_algo, k=k, algo_options=algo_options,
            sketch_dim=sketch_dim, seed=seed, cluster_seed=cluster_seed,
            aggregator=aggregator, projection=projection,
            return_sketches=return_sketches, mesh=axis.mesh,
            client_axis=axis.name, device=device)
        return (new_state._replace(
            opt_state=_round_opt_state(state, new_state.params)),
            labels, info)

    dev = resolve_device(device)
    shard = axis.even(state.n_clients)
    params = tree_map(lambda l: axis.local_rows(l, state.n_clients).to(dev),
                      state.params)
    sketches = shard.gather(sketch_stacked(
        params, projection, sketch_dim=sketch_dim, seed=seed,
        leaf_filter=_leaf_filter_for(cfg)))
    result = run_clustering(make_generator(cluster_seed, dev), sketches,
                            algo, k=k, assert_separable=assert_separable,
                            **(algo_options or {}))
    labels = result.labels
    n_clusters = int(labels.max()) + 1
    labels_t = torch.as_tensor(labels).to(dev)
    new_params, _ = _average(labels_t, n_clusters, params, aggregator, shard,
                             keep_reps=False)
    new_state = FederatedState(
        params=new_params, opt_state=_round_opt_state(state, new_params),
        n_clients=state.n_clients, step=state.step)
    info = {"n_clusters": n_clusters, "meta": result.meta, "engine": "host"}
    if return_sketches:
        info["sketches"] = sketches.cpu().numpy()
    return new_state, labels, info


@torch.no_grad()
def evaluate_per_client(state: FederatedState, cfg, batch) -> np.ndarray:
    """(C,) mean loss of each client's model on its own eval batch
    (``train_loss``: the differentiable attention, run without grad).  On
    a ``Shard(0)`` state each rank scores its own clients and every rank
    gets every client's loss."""
    from repro_torch.launch.steps import _as_batch, client_slice
    from repro_torch.models.transformer import train_loss
    from repro_torch.sharding.clients import tree_axis

    n = state.n_clients
    axis = tree_axis(state.params)
    params = axis.mine(state.params, n)
    dev = tree_leaves(params)[0].device
    batch = _as_batch(axis.mine(batch, n), dev)
    losses = [float(train_loss(client_slice(params, c), cfg,
                               client_slice(batch, c)))
              for c in range(int(tree_leaves(params)[0].shape[0]))]
    return axis.gather_clients(torch.tensor(
        losses, dtype=torch.float32, device=dev), n).cpu().numpy()


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
