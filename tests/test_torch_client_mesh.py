"""The round's client axis on a device mesh (``mesh=`` / ``client_axis=``),
on the CPU: four ranks of a gloo process group against the port without
a mesh, and against the reference on four forced host devices.

* One 4-rank world (spawned processes, one module-scoped run) drives
  every case of ``CASES`` with the mesh; the parent runs each case
  without one.  Labels must be equal, floats within rtol 1e-5, atol 1e-6
  (the all-reduce changes the order of summation); every rank must hold
  the same labels and ``n_iter``.
* The reference runs each of its paths (the session finalize, the fused
  round, the convex kNN finalize, the refusal) in a process of its own,
  with ``--xla_force_host_platform_device_count=4`` set before jax is
  imported and a ``Mesh`` with Auto axes: its program cache keys on
  shapes and not on shardings, so two meshed paths in one process can
  collide (ROADMAP queue C).  Its draws are carried across as
  ``tests/test_torch_engine.py`` carries them: its projection as
  ``projection=``, and ``init="warm"`` from the same centers on both
  sides.  Labels equal, floats within rtol 1e-5, atol 1e-5.
* A capacity the ranks do not divide (1022 on 4) is refused by both.
* Every function of ``src/repro`` with a ``mesh`` parameter has a
  counterpart in ``src/repro_torch`` that takes ``mesh`` and, on the
  round's layers, ``client_axis``.
"""
import ast
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import runtime

REPO = Path(__file__).resolve().parents[1]
RANKS = 4
C, K, SKETCH, WAVE = 256, 4, 8, 64
WORLD_TIMEOUT = 300


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One host thread a process: the tensors are small, and the four
    ranks and the parallel test workers must not oversubscribe the CPU."""
    with runtime.pinned_threads(1):
        yield


# ------------------------------------------------------------- the inputs

def federation(seed: int = 0):
    """K well-separated blobs of two-leaf client models, client i in
    blob i % K: ``({"w": (C, 4), "b": (C, 2)}, truth)`` in numpy."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(K, 6)) * 10.0
    truth = np.arange(C) % K
    theta = (centers[truth] + 0.1 * rng.normal(size=(C, 6))).astype(
        np.float32)
    return {"w": theta[:, :4], "b": theta[:, 4:]}, truth


def outlier_federation():
    """K blobs near the origin (centers of norm 1-3, spread 0.15), an
    eighth of each blob's clients moved 1.0 along one direction: a
    geometric median that is well conditioned in fp32 (|x|^2 not far
    above the in-cluster d^2) and lies ~0.1 from the cluster mean."""
    rng = np.random.default_rng(2)
    centers = rng.normal(size=(K, 6))
    truth = np.arange(C) % K
    theta = centers[truth] + 0.15 * rng.normal(size=(C, 6))
    away = rng.normal(size=6)
    theta[(np.arange(C) // K) % 8 == 0] += away / np.linalg.norm(away)
    theta = theta.astype(np.float32)
    return {"w": theta[:, :4], "b": theta[:, 4:]}, truth


def _tensors(tree):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in tree.items()}


def _flat(tree) -> np.ndarray:
    from repro_torch.utils import tree_leaves

    return np.concatenate([np.asarray(l).reshape(len(l), -1)
                           for l in tree_leaves(tree)], axis=1)


def _is_dtensor(tree) -> bool:
    from torch.distributed.tensor import DTensor

    from repro_torch.utils import tree_leaves

    return all(isinstance(l, DTensor) for l in tree_leaves(tree))


def _summary(axis, out, session=None) -> dict:
    """What a case hands back, as numpy: labels, every client's new
    parameters (gathered under a mesh: ``axis`` is the case's
    ``ClientAxis``, or ``LocalAxis`` without one), the cluster models and
    centers,
    n_iter, and whether the parameters came back as DTensors."""
    from repro_torch.utils import tree_map

    state, labels, info = out
    got = {"labels": np.asarray(labels),
           "n_iter": int(info["meta"]["n_iter"] or 0)}
    if state is not None:
        got["params"] = _flat(tree_map(lambda l: axis.full(l).numpy(),
                                       state.params))
        got["dtensor"] = _is_dtensor(state.params)
    if session is not None:
        got["centers"] = session.route_centers.numpy()
        if state is not None:
            got["models"] = _flat(tree_map(lambda l: l.numpy(),
                                           session.cluster_models()))
    return got


def _session(mesh, fed=federation, **kw):
    from repro_torch.core.engine.session import AggregationSession

    params, _ = fed()
    sess = AggregationSession(kw.pop("capacity", C), sketch_dim=SKETCH,
                              seed=0, mesh=mesh, device="cpu", **kw)
    for off in range(0, C, WAVE):
        sess.ingest(_tensors({k: v[off:off + WAVE]
                              for k, v in params.items()}))
    return sess


def _axis(mesh):
    from repro_torch.sharding.clients import client_axis_of

    return client_axis_of(mesh)


# ------------------------------------------------------------------ cases

def _finalize_case(algo_options, aggregator="mean", engine="device",
                   algorithm="kmeans-device", fed=federation):
    def case(mesh, extra):
        sess = _session(mesh, fed)
        out = sess.finalize(algorithm=algorithm, k=K, engine=engine,
                            algo_options=algo_options, aggregator=aggregator)
        return _summary(_axis(mesh), out, sess)
    return case


def case_exp_decay(mesh, extra):
    from repro_torch.core.engine.session import AggregationSession

    params, _ = federation()
    sess = AggregationSession(C, sketch_dim=SKETCH, seed=0, mesh=mesh,
                              staleness="exp_decay=2.0", device="cpu")
    for off in range(0, C, 32):       # eight stamps, eight weights
        sess.ingest(_tensors({k: v[off:off + 32] for k, v in params.items()}))
    out = sess.finalize(k=K)
    return _summary(_axis(mesh), out, sess)


def case_refinalize(mesh, extra):
    """Keyed waves, a finalize, then re-uploads and joiners under the
    sliding window (rows evicted, their slots reused) and the warm
    re-finalize."""
    from repro_torch.core.engine.session import AggregationSession
    from repro_torch.core.engine.staleness import make_staleness_policy

    params, _ = federation()
    shifted, _ = federation(1)
    sess = AggregationSession(C + 64, sketch_dim=SKETCH, seed=0, mesh=mesh,
                              device="cpu")
    for off in range(0, C, WAVE):
        sess.ingest(_tensors({k: v[off:off + WAVE]
                              for k, v in params.items()}),
                    client_ids=range(off, off + WAVE))
    sess.finalize(k=K)
    sess.staleness = make_staleness_policy("max_age=3")
    for r in range(3):
        ids = list(range(32 * r, 32 * r + 32))
        sess.ingest(_tensors({k: v[ids] for k, v in shifted.items()}),
                    client_ids=ids)
        sess.ingest(_tensors({k: v[C - 32:] for k, v in shifted.items()}),
                    client_ids=[("joiner", r, i) for i in range(32)])
    out = sess.refinalize()
    got = _summary(_axis(mesh), out, sess)
    got["refinalize"] = out[2]["refinalize"]
    got["count"] = sess.count
    return got


def _scenario_case(scenario, **options):
    """Keyed waves through a scenario's sketch hook, a finalize, then a
    re-upload of every third client (its rows lie on every rank, out of
    order in no rank's block) and the re-finalize: the hook must key each
    row as the session without a mesh keys it, by its wave's first row."""
    def case(mesh, extra):
        from repro_torch.core.engine.session import AggregationSession
        from repro_torch.scenarios import build_scenario
        from repro_torch.utils import prng

        scen = build_scenario(scenario, **options)
        key = prng.key(7)
        params, _ = federation()
        sess = AggregationSession(
            C, sketch_dim=SKETCH, seed=0, mesh=mesh, device="cpu",
            sketch_transform=lambda sk, off: scen.sketch_transform(
                key, sk, off))
        for off in range(0, C, WAVE):
            sess.ingest(_tensors({k: v[off:off + WAVE]
                                  for k, v in params.items()}),
                        client_ids=range(off, off + WAVE))
        sess.finalize(k=K)
        ids = list(range(C - 1, 0, -3))
        sess.ingest(_tensors({k: v[ids] + 0.05 for k, v in params.items()}),
                    client_ids=ids)
        out = sess.refinalize()
        got = _summary(_axis(mesh), out, sess)
        got["refinalize"] = out[2]["refinalize"]
        return got
    return case


def case_hierarchy(mesh, extra):
    from repro_torch.core.engine.hierarchy import HierarchicalSession

    params, _ = federation()
    sess = HierarchicalSession(C, shards=2, sketch_dim=SKETCH, seed=0,
                               mesh=mesh, device="cpu")
    for off in range(0, C, 96):       # waves straddle the shard edge
        sess.ingest(_tensors({k: v[off:off + 96]
                              for k, v in params.items()}))
    out = sess.finalize(k=K)
    return _summary(_axis(mesh), out, sess)


def _lam():
    from repro_torch.core.clustering.convex import lambda_interval

    params, truth = federation()
    lo, hi = lambda_interval(torch.from_numpy(_flat(params)), truth)
    return 0.5 * (lo + hi) if lo < hi else lo


def case_convex_knn(mesh, extra):
    sess = _session(mesh)
    out = sess.finalize(algorithm="convex-device", algo_options={
        "lam": extra["lam"], "edges": "knn", "knn_k": 8, "iters": 300})
    return _summary(_axis(mesh), out, sess)


def case_fused(mesh, extra):
    from repro_torch.core.federated import FederatedState, one_shot_aggregate

    params, _ = federation()
    state = FederatedState(params=_tensors(params), opt_state=None,
                           n_clients=C)
    out = one_shot_aggregate(state, None, algorithm="kmeans-device", k=K,
                             sketch_dim=SKETCH, seed=0, engine="device",
                             mesh=mesh, device="cpu")
    got = _summary(_axis(mesh), out)
    opt = out[0].opt_state
    got["moments_dtensor"] = _is_dtensor((opt["mu"], opt["nu"]))
    return got


def _method_case(name, **kw):
    def case(mesh, extra):
        from repro_torch.core.federated import FederatedState
        from repro_torch.core.federated_methods import build_federated_method

        params, _ = federation()
        state = FederatedState(params=_tensors(params), opt_state=None,
                               n_clients=C)
        method = build_federated_method(
            name, algorithm="kmeans-device", engine="device", k=K,
            sketch_dim=SKETCH, seed=0, local_steps=0, **kw)
        res = method.run(0, state, None, None, mesh=mesh)
        meta = dict(res.meta, n_iter=res.meta.get("n_iter"))
        return _summary(_axis(mesh), (res.state, res.labels,
                                      {"meta": meta}))
    return case


def _ref_case(path):
    """The port's side of a reference comparison: the reference's
    projection and warm-start centers."""
    def case(mesh, extra):
        from repro_torch.core.federated import FederatedState
        from repro_torch.core.engine.aggregate import (
            one_shot_aggregate_device)

        params = {"theta": torch.from_numpy(extra["theta"])}
        proj = torch.from_numpy(extra["projection"])
        warm = {"init": "warm",
                "init_centers": torch.from_numpy(extra["c0"])}
        if path == "fused":
            state = FederatedState(params=params, opt_state=None,
                                   n_clients=C)
            return _summary(_axis(mesh), one_shot_aggregate_device(
                state, algorithm="kmeans-device", k=K, algo_options=warm,
                sketch_dim=SKETCH, projection=proj, mesh=mesh,
                device="cpu"))
        from repro_torch.core.engine.session import AggregationSession

        sess = AggregationSession(C, sketch_dim=SKETCH, projection=proj,
                                  mesh=mesh, device="cpu")
        for off in range(0, C, WAVE):
            sess.ingest({"theta": params["theta"][off:off + WAVE]})
        if path == "main":
            out = sess.finalize(k=K, algo_options=warm)
        else:
            out = sess.finalize(algorithm="convex-device", algo_options={
                "lam": extra["lam"], "edges": "knn", "knn_k": 8,
                "iters": 300})
        return _summary(_axis(mesh), out, sess)
    return case


def case_refusal(mesh, extra):
    with pytest.raises(ValueError, match="not divisible"):
        _session(mesh, capacity=1022)
    return {"refused": True}


CASES = {
    "kmeans++": _finalize_case({"init": "kmeans++"}),
    "random": _finalize_case({"init": "random"}),
    "spectral": _finalize_case({"init": "spectral"}),
    "minibatch": _finalize_case({"init": "kmeans++", "batch_m": 100,
                                 "iters": 30}),
    "restarts": _finalize_case({"init": "kmeans++", "restarts": 3}),
    "trimmed_mean": _finalize_case({"init": "kmeans++",
                                    "aggregator": "trimmed_mean"},
                                   aggregator="trimmed_mean"),
    "median": _finalize_case({"init": "kmeans++"}, aggregator="median"),
    "geometric_median": _finalize_case({"init": "kmeans++"},
                                       aggregator="geometric_median",
                                       fed=outlier_federation),
    "host_kmeans++": _finalize_case(None, engine="host",
                                    algorithm="kmeans++"),
    "exp_decay": case_exp_decay,
    "refinalize": case_refinalize,
    "dp_reupload": _scenario_case("dp", epsilon=1000.0),
    "spoof_reupload": _scenario_case("byzantine", attack="spoof", frac=0.2,
                                     scale=1.0),
    "hierarchy": case_hierarchy,
    "convex_knn": case_convex_knn,
    "fused": case_fused,
    "odcl_run": _method_case("odcl"),
    "ifca_run": _method_case("ifca", rounds=2, assign="sketch",
                             init="clients"),
}
REF_PATHS = ("main", "fused", "convex")
REF_CASES = {f"ref_{p}": _ref_case(p) for p in REF_PATHS}
MESH_ONLY = {"refusal": case_refusal, **REF_CASES}


# ------------------------------------------------------------ the world

def _rank_main(rank: int, port: int, out_dir: str, extra: dict) -> None:
    """One rank: join the group, run every case with the mesh, save the
    results."""
    from repro_torch.launch.mesh import client_mesh

    with runtime.pinned_threads(1):
        mesh = client_mesh(RANKS, backend="gloo", device="cpu", rank=rank,
                           init_method=f"tcp://localhost:{port}")
        results = {name: case(mesh, extra)
                   for name, case in {**CASES, **MESH_ONLY}.items()}
        torch.distributed.destroy_process_group()
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh

which, src, dst = sys.argv[1:4]
inp = np.load(src)
mesh = Mesh(np.array(jax.devices()), ("data",))     # Auto axes
out = {}
if which == "refusal":
    from repro.core.engine import AggregationSession
    try:
        AggregationSession(1022, sketch_dim=8, mesh=mesh)
        out["refused"] = np.array(False)
    except ValueError:
        out["refused"] = np.array(True)
else:
    theta = inp["theta"]
    warm = {"init": "warm", "init_centers": jnp.asarray(inp["c0"])}
    if which == "fused":
        from repro.core.engine.aggregate import one_shot_aggregate_device
        from repro.core.federated import FederatedState
        from repro.optim import adamw_init
        params = {"theta": jnp.asarray(theta)}
        state = FederatedState(params=params,
                               opt_state=jax.vmap(adamw_init)(params),
                               n_clients=len(theta))
        new, labels, info = one_shot_aggregate_device(
            state, None, algorithm="kmeans-device", k=%(k)d,
            algo_options=warm, sketch_dim=%(s)d, seed=0, mesh=mesh)
    else:
        from repro.core.engine import AggregationSession
        sess = AggregationSession(len(theta), sketch_dim=%(s)d, seed=0,
                                  mesh=mesh)
        for off in range(0, len(theta), %(w)d):
            sess.ingest({"theta": jnp.asarray(theta[off:off + %(w)d])})
        if which == "main":
            new, labels, info = sess.finalize(k=%(k)d, algo_options=warm)
        else:
            new, labels, info = sess.finalize(
                algorithm="convex-device", algo_options={
                    "lam": float(inp["lam"]), "edges": "knn", "knn_k": 8,
                    "iters": 300})
        out["centers"] = np.asarray(sess.route_centers)
    out["labels"] = np.asarray(labels)
    out["params"] = np.asarray(new.params["theta"])
    out["n_iter"] = np.asarray(info["meta"]["n_iter"])
    out["devices"] = np.asarray(len(new.params["theta"].sharding.device_set))
np.savez(dst, **out)
""" % {"k": K, "s": SKETCH, "w": WAVE}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Start the reference's four processes, run the 4-rank world, then
    collect both.  Returns ``{"ranks": [results of rank r], "reference":
    {path: npz}, "extra": the shared inputs}``."""
    import torch.multiprocessing as mp

    from test_torch_sketch import ref_projection

    tmp = tmp_path_factory.mktemp("client_mesh")
    params, _ = federation()
    theta = _flat(params)
    projection = ref_projection(0, theta.shape[1], SKETCH)
    sk = theta @ projection
    extra = {"theta": theta, "projection": projection, "lam": _lam(),
             "c0": np.ascontiguousarray(sk[:K]).astype(np.float32)}
    np.savez(tmp / "in.npz", **extra)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    refs = {p: subprocess.Popen(
        [sys.executable, "-c", REFERENCE, p, str(tmp / "in.npz"),
         str(tmp / f"{p}.npz")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
        for p in REF_PATHS + ("refusal",)}
    try:
        ctx = mp.start_processes(_rank_main, args=(_free_port(), str(tmp),
                                                   extra),
                                 nprocs=RANKS, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + WORLD_TIMEOUT
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                pytest.fail(f"the {RANKS}-rank world ran past "
                            f"{WORLD_TIMEOUT} s")
        ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                 for r in range(RANKS)]
        reference = {}
        for p, proc in refs.items():
            out, err = proc.communicate(timeout=WORLD_TIMEOUT)
            assert proc.returncode == 0, out + err
            reference[p] = dict(np.load(tmp / f"{p}.npz"))
    finally:
        for proc in refs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    yield {"ranks": ranks, "reference": reference, "extra": extra}


# ------------------------------------------------------------------ tests

_UNMESHED = {}


def unmeshed(name, extra):
    if name not in _UNMESHED:
        _UNMESHED[name] = CASES[name](None, extra)
    return _UNMESHED[name]


def _close(got, want, atol):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("name", list(CASES))
def test_meshed_round_equals_the_unmeshed_round(world, name):
    got = world["ranks"][0][name]
    want = unmeshed(name, world["extra"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    assert got["n_iter"] == want["n_iter"]
    for key in ("params", "centers", "models"):
        if key in want:
            _close(got[key], want[key], 1e-6)
    for key in ("refinalize", "count"):
        assert got.get(key) == want.get(key)
    if "params" in got:
        # IFCA takes the mesh and does not use it, as the reference
        assert got["dtensor"] == (name != "ifca_run")
        assert not want["dtensor"]


@pytest.mark.parametrize("name", list(CASES) + list(REF_CASES))
def test_every_rank_holds_the_same_round(world, name):
    first = world["ranks"][0][name]
    for r in range(1, RANKS):
        other = world["ranks"][r][name]
        np.testing.assert_array_equal(other["labels"], first["labels"])
        assert other["n_iter"] == first["n_iter"]
        for key in ("params", "centers", "models"):
            if key in first:
                np.testing.assert_array_equal(other[key], first[key])


def test_geometric_median_is_as_close_to_fp64_as_the_unmeshed(world):
    """On a federation whose median is well conditioned in fp32, the
    meshed and the unmeshed per-client medians both lie within rtol 1e-5,
    atol 1e-6 of the fp64 median of the same partition, while each
    cluster's plain mean lies over 1e-2 from it: an aggregator that
    skipped the Weiszfeld steps could not pass."""
    from repro_torch.core.engine.aggregators import GeometricMedianAggregator

    got = world["ranks"][0]["geometric_median"]
    want = unmeshed("geometric_median", world["extra"])
    params, _ = outlier_federation()
    lab = torch.from_numpy(want["labels"]).long()
    onehot = torch.nn.functional.one_hot(lab, K).double()
    exact, mean = [], []
    for key in ("b", "w"):                   # the tree's leaf order
        leaf = torch.from_numpy(np.ascontiguousarray(params[key])).double()
        exact.append(GeometricMedianAggregator()(leaf, lab, onehot,
                                                 onehot.sum(0)))
        mean.append((onehot.T @ leaf) / onehot.sum(0)[:, None])
    exact, mean = torch.cat(exact, 1), torch.cat(mean, 1)
    assert np.abs((mean - exact).numpy()).max() > 1e-2
    for side in (want, got):
        _close(side["params"], exact[lab].numpy(), 1e-6)


def test_warm_refinalize_is_taken_under_the_mesh(world):
    got = world["ranks"][0]["refinalize"]
    assert got["refinalize"] == "warm"
    assert got["count"] < C + 3 * 32      # the window evicted rows


def test_fused_round_shards_the_fresh_moments(world):
    assert world["ranks"][0]["fused"]["moments_dtensor"]


@pytest.mark.parametrize("path", REF_PATHS)
def test_meshed_port_equals_the_meshed_reference(world, path):
    got = world["ranks"][0][f"ref_{path}"]
    want = world["reference"][path]
    assert int(want["devices"]) == RANKS     # the reference did shard
    np.testing.assert_array_equal(got["labels"], want["labels"])
    assert got["n_iter"] == int(want["n_iter"])
    np.testing.assert_allclose(got["params"], want["params"], rtol=1e-5,
                               atol=1e-5)
    if "centers" in want:
        np.testing.assert_allclose(got["centers"], want["centers"],
                                   rtol=1e-5, atol=1e-5)


def test_capacity_the_ranks_do_not_divide_is_refused_by_both(world):
    assert world["ranks"][0]["refusal"]["refused"]
    assert bool(world["reference"]["refusal"]["refused"])


# ------------------------------------------------- the signature parity

ROUND_LAYERS = ("core/", "launch/simulate.py")


def _mesh_functions(root: Path) -> dict:
    """{(module path, qualified name): parameter names} of every function
    and method under ``root`` with a ``mesh`` parameter."""
    found = {}
    for path in sorted(root.rglob("*.py")):
        tree = ast.parse(path.read_text())
        stack = [(tree, "")]
        while stack:
            node, prefix = stack.pop()
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    stack.append((child, prefix + child.name + "."))
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                    a = child.args
                    names = {x.arg for x in a.posonlyargs + a.args
                             + a.kwonlyargs}
                    key = (str(path.relative_to(root)),
                           prefix + child.name)
                    found[key] = names
                    stack.append((child, prefix + child.name + "."))
    return found


REF_MESH = sorted(key for key, names in
                  _mesh_functions(REPO / "src" / "repro").items()
                  if "mesh" in names)
# The reference's per-mesh program factories have no program to make in
# the port: their mesh goes to the entry point that runs them (the
# constraint itself to ``ClientAxis``).  Its ``NamedSharding`` helper of
# the dry run is the port's DTensor placement.
PORTED_AS = {
    ("launch/dryrun.py", "_named"): ("launch/dryrun.py", "place"),
    ("core/engine/aggregate.py", "_constrainer"):
        ("sharding/clients.py", "ClientAxis.__init__"),
    ("core/engine/aggregate.py", "_round_program"):
        ("core/engine/aggregate.py", "one_shot_aggregate_device"),
    ("core/engine/aggregate.py", "_mean_program"):
        ("core/engine/session.py", "AggregationSession.__init__"),
    ("core/engine/aggregate.py", "_weighted_mean_program"):
        ("core/engine/hierarchy.py", "HierarchicalSession.__init__"),
}


@pytest.mark.parametrize("key", REF_MESH, ids="::".join)
def test_every_mesh_function_has_a_port_that_takes_the_mesh(key):
    """Each takes ``mesh``; on the round's layers also ``client_axis``."""
    port = _mesh_functions(REPO / "src" / "repro_torch")
    path, name = PORTED_AS.get(key, key)
    assert (path, name) in port, f"no counterpart of {key} in the port"
    assert "mesh" in port[(path, name)], f"{path}::{name} takes no mesh"
    if key[0].startswith(ROUND_LAYERS):
        assert "client_axis" in port[(path, name)], \
            f"{path}::{name} takes no client_axis"


# ------------------------------------------------ the refusals under a mesh

# The port's own refusals under a mesh: none.  A RouteServer over a
# sharded session ingests and runs rounds on rank 0, the controller, and
# the other ranks follow its log (``tests/test_torch_mesh_route_server.py``).
MESH_REFUSALS: set = set()


def _mesh_refusals(root: Path) -> dict:
    """{(module path, qualified name): [raise statements]} of every
    function under ``root`` that raises in the body of an ``if`` whose
    test asks whether a mesh ``is not None``."""
    found = {}

    def own_nodes(fn):
        """The function's nodes, nested functions and classes left out."""
        todo = list(fn.body)
        while todo:
            node = todo.pop()
            yield node
            todo.extend(c for c in ast.iter_child_nodes(node)
                        if not isinstance(c, (ast.FunctionDef,
                                              ast.AsyncFunctionDef,
                                              ast.ClassDef)))

    for path in sorted(root.rglob("*.py")):
        tree = ast.parse(path.read_text())
        stack = [(tree, "")]
        while stack:
            node, prefix = stack.pop()
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    stack.append((child, prefix + child.name + "."))
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                    name = prefix + child.name
                    stack.append((child, name + "."))
                    raises = [
                        ast.unparse(r) for n in own_nodes(child)
                        if isinstance(n, ast.If)
                        and "mesh" in ast.unparse(n.test)
                        and "is not None" in ast.unparse(n.test)
                        for stmt in n.body for r in ast.walk(stmt)
                        if isinstance(r, ast.Raise)]
                    if raises:
                        found[(str(path.relative_to(root)), name)] = raises
    return found


def test_no_port_function_refuses_a_mesh_the_reference_takes():
    """Every refusal under a mesh in the port is its reference
    counterpart's own, or one of ``MESH_REFUSALS``."""
    ref = _mesh_refusals(REPO / "src" / "repro")
    port = _mesh_refusals(REPO / "src" / "repro_torch")
    as_ref = {v: k for k, v in PORTED_AS.items()}
    extra = sorted(key for key in port if key not in MESH_REFUSALS
                   and as_ref.get(key, key) not in ref)
    assert not extra, f"refused under a mesh, not in the reference: {extra}"
