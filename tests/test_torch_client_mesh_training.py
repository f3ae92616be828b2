"""Algorithm 1's training phases on a client mesh, on the CPU: the local
steps, the round, the post steps, IFCA, FedAvg, local-only, the
per-client evaluation and the checkpoint of a federation whose client
axis is ``Shard(0)`` over four ranks of a gloo process group.

* One 4-rank world (spawned processes, one module-scoped run) drives
  every case of ``CASES`` on a sharded federation; the parent runs each
  case on the unmeshed one.  The federation is the reference tests'
  reduced qwen2 (1 layer, d 64, vocab 64, fp32), C = 8 clients planted
  in K = 2 clusters (client i is init i % 2 plus 1e-2 noise), batch 2,
  seq 16.  Labels and every client's local-phase losses must be equal:
  each client's step runs the same arithmetic on the same rows.  Floats
  that went through an all-reduce (the round's and IFCA's averages,
  FedAvg's mean, and what later steps make of them) within rtol 1e-5,
  atol 1e-6, as ``tests/test_torch_client_mesh.py`` holds them.
* Rank r holds clients [2r, 2r + 2) of every leaf and moment, and a
  training step sends no collective.
* The reference runs the same ODCL (device engine, 2 local and 2 post
  steps) with its federation on four forced host devices, in a process
  of its own; its projection and the warm centers are carried across as
  ``tests/test_torch_federated_lm.py`` carries them.
"""
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
C, K, BATCH, SEQ, S = 8, 2, 2, 16, 32
PER = C // RANKS
LR = 1e-3
WORLD_TIMEOUT = 300


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One host thread a process: the tensors are small, and the four
    ranks and the parallel test workers must not oversubscribe the CPU."""
    with runtime.pinned_threads(1):
        yield


# ------------------------------------------------------------- the inputs

def tiny_cfg():
    from repro_torch.configs import get_config

    return get_config("qwen2_0_5b").reduced(n_layers=1, max_d_model=64,
                                            max_vocab=64)


def planted() -> dict:
    """The planted federation as a numpy tree: client i is the port's init
    of seed i % K plus 1e-2 normal noise."""
    from repro_torch.models.transformer import init_tree
    from repro_torch.utils import tree_map

    cfg = tiny_cfg()
    bases = [init_tree(cfg, seed=s, device="cpu") for s in range(K)]
    rng = np.random.default_rng(0)

    def stack(*ls):
        base = np.stack([ls[i % K].numpy() for i in range(C)])
        return (base + 1e-2 * rng.normal(size=base.shape)).astype(np.float32)

    return tree_map(stack, *bases)


def batches(seed=0):
    from repro_torch.data import ClusteredTokenStream, make_lm_batch_iterator

    stream = ClusteredTokenStream(n_clients=C, n_clusters=K, vocab_size=64,
                                  seed=seed, branching=4)
    raw = make_lm_batch_iterator(stream, clients_per_batch=list(range(C)),
                                 per_client_batch=BATCH, seq_len=SEQ)
    return ({"tokens": t, "labels": l} for t, l in raw)


def eval_batch():
    from repro_torch.data import ClusteredTokenStream
    from repro_torch.launch.steps import make_eval_batch

    stream = ClusteredTokenStream(n_clients=C, n_clusters=K, vocab_size=64,
                                  seed=0, branching=4)
    return make_eval_batch(stream, n_clients=C, batch=BATCH, seq_len=SEQ)


def opt():
    from repro_torch.optim import AdamWConfig

    return AdamWConfig(lr=LR, weight_decay=0.0)


def _axis(mesh):
    from repro_torch.sharding.clients import client_axis_of

    return client_axis_of(mesh)


def state_of(mesh, params):
    """The planted federation placed on the mesh's client axis (each rank
    wraps its own rows) with fresh AdamW moments, or unmeshed."""
    from repro_torch.core.federated import FederatedState
    from repro_torch.optim import adamw_init
    from repro_torch.utils import tree_map

    axis = _axis(mesh)
    lo, hi = axis.owned(C)
    local = tree_map(lambda l: torch.from_numpy(l[lo:hi].copy()), params)
    placed = axis.place(local, C)
    return FederatedState(params=placed, opt_state=adamw_init(placed, C),
                          n_clients=C)


def _full(mesh, tree) -> dict:
    """A stacked tree as numpy on every rank ({path: array})."""
    from repro_torch.utils import tree_leaves_with_path

    axis = _axis(mesh)
    return {p: axis.full(l).numpy() for p, l in tree_leaves_with_path(tree)}


def _dtensor(tree) -> bool:
    from torch.distributed.tensor import DTensor

    from repro_torch.utils import tree_leaves

    return all(isinstance(l, DTensor) for l in tree_leaves(tree))


def _result(mesh, res) -> dict:
    """What a method case hands back, as numpy."""
    opt_state = res.state.opt_state
    return {"labels": np.asarray(res.labels),
            "metrics": [{k: v for k, v in r.items() if k != "round_ms"}
                        for r in res.round_metrics],
            "params": _full(mesh, res.state.params),
            "moments": _full(mesh, opt_state),
            "dtensor": _dtensor(res.state.params),
            "moments_dtensor": _dtensor(opt_state),
            "step": res.state.step}


# ------------------------------------------------------------------ cases

def _method_case(name, **kw):
    def case(mesh, extra):
        from repro_torch.core.federated_methods import build_federated_method

        method = build_federated_method(name, opt=opt(), **kw)
        res = method.run(0, state_of(mesh, extra["params"]), tiny_cfg(),
                         batches(), mesh=mesh)
        return _result(mesh, res)
    return case


def case_ifca_without_mesh_arg(mesh, extra):
    """IFCA on a sharded state, ``mesh=`` not given: the axis comes from
    the leaves."""
    from repro_torch.core.federated_methods import IFCAFederated

    res = IFCAFederated(k=K, rounds=2, local_steps=1, assign="sketch",
                        init="perturb", sketch_dim=S, opt=opt()).run(
        0, state_of(mesh, extra["params"]), tiny_cfg(), batches())
    return _result(mesh, res)


def case_evaluate(mesh, extra):
    from repro_torch.core.federated import evaluate_per_client

    state = state_of(mesh, extra["params"])
    return {"losses": evaluate_per_client(state, tiny_cfg(), eval_batch())}


def case_init(mesh, extra):
    """``init_federation(mesh=)``: independent inits drawn in turn, each
    rank keeping its own."""
    from repro_torch.core.federated import init_federation

    state = init_federation(0, tiny_cfg(), C, same_init=False, device="cpu",
                            mesh=mesh)
    return {"params": _full(mesh, state.params),
            "moments": _full(mesh, state.opt_state),
            "dtensor": _dtensor(state.params),
            "moments_dtensor": _dtensor(state.opt_state)}


def case_checkpoint(mesh, extra):
    """Save a trained federation, read the file's bytes, restore it onto
    the state as a template."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.core.federated import local_training

    state = state_of(mesh, extra["params"])
    state, _ = local_training(state, tiny_cfg(), batches(), 1, opt())
    where = os.path.join(extra["tmp"], "mesh" if mesh else "plain")
    path = save_checkpoint(where, 1, state.params)
    back = restore_checkpoint(where, 1, state.params)
    with open(path, "rb") as f:
        data = f.read()
    return {"bytes": data, "restored": _full(mesh, back),
            "saved": _full(mesh, state.params),
            "restored_dtensor": _dtensor(back)}


CASES = {
    "odcl_device": _method_case("odcl", algorithm="kmeans++", k=K,
                                engine="device", sketch_dim=S, local_steps=2,
                                post_steps=2),
    "odcl_host": _method_case("odcl", algorithm="kmeans++", k=K,
                              engine="host", sketch_dim=S, local_steps=2,
                              post_steps=2),
    "ifca_sketch": _method_case("ifca", k=K, rounds=2, local_steps=1,
                                assign="sketch", init="perturb",
                                sketch_dim=S),
    "ifca_loss": _method_case("ifca", k=K, rounds=2, local_steps=1,
                              warmup_steps=1, assign="loss", init="clients",
                              carry_opt_state=True, sketch_dim=S),
    "ifca_sketch_no_steps": _method_case("ifca", k=K, rounds=2,
                                         local_steps=0, assign="sketch",
                                         init="clients", sketch_dim=S),
    "ifca_without_mesh_arg": case_ifca_without_mesh_arg,
    "fedavg": _method_case("fedavg", rounds=2, local_steps=1),
    "local_only": _method_case("local-only", local_steps=2),
    "evaluate": case_evaluate,
    "init": case_init,
    "checkpoint": case_checkpoint,
}


# ------------------------------------------------- the mesh-only cases

def case_placement(mesh, extra):
    """Each rank's local rows of every leaf, moment and step."""
    from repro_torch.utils import tree_leaves_with_path

    state = state_of(mesh, extra["params"])
    local = {f"params/{p}": l.to_local().numpy()
             for p, l in tree_leaves_with_path(state.params)}
    local.update({f"opt/{p}": l.to_local().numpy()
                  for p, l in tree_leaves_with_path(state.opt_state)})
    return {"local": local}


def case_no_collective(mesh, extra):
    """A training step on the sharded state sends no collective (DTensor's
    or the axis's); ``local_training`` sends only its gathers of the
    (C,) losses.  The step updates the local shards in place."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch import obs
    from repro_torch.core.federated import local_training
    from repro_torch.launch.steps import make_local_train_step
    from repro_torch.utils import tree_leaves

    state = state_of(mesh, extra["params"])
    step = make_local_train_step(tiny_cfg(), opt(), remat="none")
    it = batches()
    ptrs = [l.to_local().data_ptr()
            for l in tree_leaves((state.params, state.opt_state))]
    placements = [l.placements
                  for l in tree_leaves((state.params, state.opt_state))]
    obs.reset()
    with CommDebugMode() as comm:
        loss, params, opt_state = step(state.params, state.opt_state,
                                       next(it))
    step_counters = dict(obs.snapshot()["counters"])
    obs.reset()
    state, losses = local_training(state, tiny_cfg(), it, 2, opt())
    counters = obs.snapshot()["counters"]
    leaves = tree_leaves((state.params, state.opt_state))
    return {"step_collectives": comm.get_total_counts(),
            "step_mesh_counters": {k: v for k, v in step_counters.items()
                                   if k.startswith("mesh.")},
            "training_counters": {k: v for k, v in counters.items()
                                  if k.startswith("mesh.")},
            "step_loss_rows": int(loss.shape[0]),
            "in_place": [l.to_local().data_ptr() for l in leaves] == ptrs,
            "placements_kept": [l.placements for l in leaves] == placements,
            "steps": state.opt_state["step"].to_local().numpy(),
            "losses": np.stack(losses)}


def case_route_server(mesh, extra):
    """A RouteServer over a meshed session: rank 0 ingests and runs a
    round through it, the other ranks follow its log and refuse ingest
    and rounds (naming rank 0, the controller); then every rank routes
    through its own server."""
    from repro_torch.core.engine.session import AggregationSession
    from repro_torch.serving.server import RouteServer
    from repro_torch.serving.batching import ServingError

    rng = np.random.default_rng(1)
    pts = (rng.normal(size=(64, 8)) + 6.0 * (np.arange(64) % 2)[:, None]
           ).astype(np.float32)
    sess = AggregationSession(64, sketch_dim=8, seed=0, mesh=mesh,
                              device="cpu")
    sess.ingest(sketches=torch.from_numpy(pts[:32]),
                client_ids=list(range(32)))
    sess.finalize(k=2)
    refused = {}
    with RouteServer(sess, max_batch=16, max_wait_ms=0.5) as srv:
        if _axis(mesh).rank == 0:
            srv.ingest(sketches=torch.from_numpy(pts[32:]),
                       client_ids=list(range(32, 64)))
            srv.finalize(k=2)
        else:
            for what, call in (
                    ("ingest", lambda: srv.ingest(sketches=torch.from_numpy(
                        pts[:4]))),
                    ("finalize", lambda: srv.finalize(k=2)),
                    ("refinalize", lambda: srv.refinalize()),
                    ("maybe_refinalize", lambda: srv.maybe_refinalize())):
                try:
                    call()
                    refused[what] = None
                except ServingError as e:
                    refused[what] = str(e)
    with RouteServer(sess, max_batch=16, max_wait_ms=0.5) as srv:
        got = [srv.route(p, timeout=30.0) for p in pts[:8]]
    return {"routed": got, "batch": np.asarray(sess.route(pts[:8])).tolist(),
            "refused": refused, "clock": sess.clock,
            "labels": np.asarray(sess.served_round.out[1]),
            "served_clock": sess.served_round.clock}


def case_simulate_qps(mesh, extra):
    from repro_torch.launch.simulate import simulate

    summary = simulate(clients=256, clusters=4, wave=64, sketch_dim=8,
                       qps_callers=4, qps_duration=0.2, mesh=mesh,
                       device="cpu")
    return {"qps_server": summary["qps_server"],
            "labels": np.asarray(summary.round["labels"]),
            "purity": summary["purity"]}


def case_ref_odcl(mesh, extra):
    """The port's side of the comparison with the meshed reference: its
    projection and the warm centers (the sketches of the two inits)."""
    from repro_torch.core.federated_methods import ODCLFederated

    res = ODCLFederated(
        algorithm="kmeans-device", k=K, engine="device", sketch_dim=S,
        algo_options={"init": "warm",
                      "init_centers": torch.from_numpy(extra["c0"])},
        local_steps=2, post_steps=2, opt=opt(), seed=0,
        projection=torch.from_numpy(extra["projection"])).run(
        0, state_of(mesh, extra["params"]), tiny_cfg(), batches(), mesh=mesh)
    return _result(mesh, res)


MESH_ONLY = {"placement": case_placement, "no_collective": case_no_collective,
             "route_server": case_route_server,
             "simulate_qps": case_simulate_qps, "ref_odcl": case_ref_odcl}


# ------------------------------------------------------------ the world

def _rank_main(rank: int, port: int, out_dir: str, extra: dict) -> None:
    """One rank: join the group, run every case on the sharded
    federation, save the results."""
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
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

src, dst = sys.argv[1:3]
inp = dict(np.load(src))
from repro.configs import get_config
from repro.core.federated import FederatedState
import repro.core.federated_methods as fm
from repro.core.federated_methods import ODCLFederated
from repro.data import ClusteredTokenStream, make_lm_batch_iterator
from repro.models import init_params
from repro.optim import AdamWConfig, adamw_init

cfg = get_config("qwen2_0_5b").reduced(n_layers=1, max_d_model=64,
                                       max_vocab=64)
params = {}
for path, arr in inp.items():
    if path.startswith("params/"):
        node = params
        *keys, last = path[len("params/"):].split("/")
        for key in keys:
            node = node.setdefault(key, {})
        node[last] = jnp.asarray(arr)
want = jax.tree_util.tree_structure(init_params(jax.random.PRNGKey(0), cfg))
assert jax.tree_util.tree_structure(
    jax.tree_util.tree_map(lambda l: l[0], params)) == want
mesh = Mesh(np.array(jax.devices()), ("data",))     # Auto axes
c = int(inp["n_clients"])
on_data = NamedSharding(mesh, P("data"))
state = FederatedState(
    params=jax.device_put(params, on_data),
    opt_state=jax.device_put(jax.vmap(adamw_init)(params), on_data),
    n_clients=c)
stream = ClusteredTokenStream(n_clients=c, n_clusters=%(k)d, vocab_size=64,
                              seed=0, branching=4)
raw = make_lm_batch_iterator(stream, clients_per_batch=list(range(c)),
                             per_client_batch=%(b)d, seq_len=%(s)d)
it = ({"tokens": t, "labels": l} for t, l in raw)
phases = []                 # every client's loss at every step, by phase
inner = fm.local_training
def recording(*args, **kw):
    state, losses = inner(*args, **kw)
    phases.append(np.stack([np.asarray(l) for l in losses]))
    return state, losses
fm.local_training = recording
method = ODCLFederated(
    algorithm="kmeans-device", k=%(k)d, engine="device", sketch_dim=%(sk)d,
    algo_options={"init": "warm", "init_centers": jnp.asarray(inp["c0"])},
    local_steps=2, post_steps=2,
    opt=AdamWConfig(lr=%(lr)r, weight_decay=0.0), seed=0)
res = method.run(jax.random.PRNGKey(0), state, cfg, it, mesh=mesh)
out = {"labels": np.asarray(res.labels), "losses_local": phases[0],
       "losses_post": phases[1]}
leaves = jax.tree_util.tree_leaves_with_path(res.state.params)
for path, leaf in leaves:
    name = "/".join(str(getattr(p, "key", p)) for p in path)
    out["params/" + name] = np.asarray(leaf)
out["devices"] = np.asarray(len(leaves[0][1].sharding.device_set))
from repro.launch.simulate import simulate
for i, kw in enumerate(%(refusals)r):
    try:
        simulate(clients=64, clusters=2, shards=2, **kw)
        out[f"refusal{i}"] = np.asarray("")
    except ValueError as e:
        out[f"refusal{i}"] = np.asarray(str(e))
np.savez(dst, **out)
"""


# ``--shards > 1`` with a mutation knob or another method than the round
SHARD_REFUSALS = ({"churn": 8}, {"reupload_frac": 0.25}, {"max_age": 3},
                  {"method": "ifca"})
REFERENCE %= {"k": K, "b": BATCH, "s": SEQ, "sk": S, "lr": LR,
              "refusals": SHARD_REFUSALS}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Start the reference's process, run the 4-rank world, then collect
    both.  Returns ``{"ranks": [results of rank r], "reference": npz,
    "extra": the shared inputs}``."""
    import torch.multiprocessing as mp

    from test_torch_sketch import ref_projection

    from repro_torch.utils import tree_leaves, tree_leaves_with_path

    tmp = tmp_path_factory.mktemp("client_mesh_training")
    params = planted()
    n = sum(int(np.prod(l.shape[1:])) for l in tree_leaves(params))
    projection = ref_projection(0, n, S)
    flat = np.concatenate([l.reshape(C, -1) for l in tree_leaves(params)],
                          axis=1)
    # the sketches of the two planted inits' first clients
    c0 = np.ascontiguousarray((flat[:K] @ projection).astype(np.float32))
    extra = {"params": params, "projection": projection, "c0": c0,
             "tmp": str(tmp)}
    np.savez(tmp / "in.npz", c0=c0, n_clients=C,
             **{f"params/{p}": l for p, l in tree_leaves_with_path(params)})
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(tmp / "in.npz"),
         str(tmp / "ref.npz")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
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
        out, err = ref.communicate(timeout=WORLD_TIMEOUT)
        assert ref.returncode == 0, out + err
        reference = dict(np.load(tmp / "ref.npz"))
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    yield {"ranks": ranks, "reference": reference, "extra": extra}


# ------------------------------------------------------------------ tests

_UNMESHED = {}


def unmeshed(name, extra):
    if name not in _UNMESHED:
        _UNMESHED[name] = CASES[name](None, extra)
    return _UNMESHED[name]


def _close(got: dict, want: dict, steps: int = 0):
    """Floats that went through an all-reduce: within rtol 1e-5, atol
    1e-6; after ``steps`` AdamW steps from an average, the bounds of
    ``test_torch_train_step.assert_tree_close`` (Adam divides a gradient
    by its RMS, so a rounding-level gradient, the key bias's, moves by
    lr-sized noise)."""
    from test_torch_train_step import assert_tree_close

    assert got.keys() == want.keys()
    if not steps:
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                       atol=1e-6, err_msg=key)
        return
    assert_tree_close({k: torch.from_numpy(v) for k, v in got.items()},
                      want, move=steps * LR)


# the phases whose losses come before any average (equal bit for bit),
# and the AdamW steps taken after the first average
EXACT_PHASES = {"odcl_device": ("local",), "odcl_host": ("local",),
                "local_only": ("local",)}
STEPS_AFTER_AVERAGE = {"odcl_device": 2, "odcl_host": 2, "ifca_sketch": 2,
                       "ifca_loss": 2, "ifca_sketch_no_steps": 0,
                       "ifca_without_mesh_arg": 2, "fedavg": 1,
                       "local_only": 0}


@pytest.mark.parametrize("name", list(STEPS_AFTER_AVERAGE))
def test_meshed_training_equals_the_unmeshed(world, name):
    got = world["ranks"][0][name]
    want = unmeshed(name, world["extra"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    assert got["step"] == want["step"]
    assert len(got["metrics"]) == len(want["metrics"])
    for g, w in zip(got["metrics"], want["metrics"]):
        assert g.keys() == w.keys()
        exact = w.get("phase") in EXACT_PHASES.get(name, ())
        for key in ("losses", "client_losses", "loss_first", "loss_last"):
            if key not in w or w[key] is None:
                continue
            if exact:
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
            else:
                np.testing.assert_allclose(g[key], w[key], rtol=1e-5,
                                           atol=1e-6, err_msg=key)
        for key in ("assign_churn", "cluster_sizes", "n_clusters", "steps"):
            assert g.get(key) == w.get(key)
    steps = STEPS_AFTER_AVERAGE[name]
    _close(got["params"], want["params"], steps)
    if steps:
        from test_torch_train_step import assert_tree_close

        assert_tree_close({k: torch.from_numpy(v)
                           for k, v in got["moments"].items()},
                          want["moments"])
    else:
        _close(got["moments"], want["moments"])
    # the state keeps its placements (and the unmeshed its plain tensors)
    assert got["dtensor"] and got["moments_dtensor"]
    assert not want["dtensor"] and not want["moments_dtensor"]


@pytest.mark.parametrize("name", list(CASES))
def test_every_rank_returns_the_same(world, name):
    first = world["ranks"][0][name]
    for r in range(1, RANKS):
        other = world["ranks"][r][name]
        for key in ("labels", "losses", "bytes"):
            if key in first:
                np.testing.assert_array_equal(other[key], first[key])
        for key in ("params", "moments", "restored"):
            for path in first.get(key, {}):
                np.testing.assert_array_equal(other[key][path],
                                              first[key][path])


def test_local_only_changes_nothing_but_the_steps(world):
    got = world["ranks"][0]["local_only"]
    want = unmeshed("local_only", world["extra"])
    # no average anywhere: the models are equal bit for bit
    for path in want["params"]:
        np.testing.assert_array_equal(got["params"][path],
                                      want["params"][path])
    assert got["labels"].tolist() == list(range(C))


def test_evaluate_per_client_equals_the_unmeshed(world):
    got = world["ranks"][0]["evaluate"]["losses"]
    want = unmeshed("evaluate", world["extra"])["losses"]
    assert got.shape == (C,) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_init_federation_on_the_mesh_draws_the_unmeshed_clients(world):
    got = world["ranks"][0]["init"]
    want = unmeshed("init", world["extra"])
    for key in ("params", "moments"):
        for path in want[key]:
            np.testing.assert_array_equal(got[key][path], want[key][path])
    assert got["dtensor"] and got["moments_dtensor"]
    # independent inits: no two clients alike
    emb = got["params"]["embed"]
    assert not np.array_equal(emb[0], emb[1])


def test_checkpoint_of_the_mesh_is_the_unmeshed_file(world):
    got = world["ranks"][0]["checkpoint"]
    want = unmeshed("checkpoint", world["extra"])
    assert got["bytes"] == want["bytes"]
    for path in got["saved"]:
        np.testing.assert_array_equal(got["restored"][path],
                                      got["saved"][path])
    assert got["restored_dtensor"] and not want["restored_dtensor"]


def test_rank_r_holds_clients_2r_to_2r_plus_2(world):
    from repro_torch.utils import tree_leaves_with_path

    params = world["extra"]["params"]
    for r in range(RANKS):
        local = world["ranks"][r]["placement"]["local"]
        for path, leaf in tree_leaves_with_path(params):
            np.testing.assert_array_equal(local[f"params/{path}"],
                                          leaf[2 * r:2 * r + 2])
            for m in ("mu", "nu"):
                mine = local[f"opt/{m}/{path}"]
                assert mine.shape == leaf[2 * r:2 * r + 2].shape
                assert not mine.any()
        assert local["opt/step"].shape == (PER,)


def test_a_training_step_sends_no_collective(world):
    for r in range(RANKS):
        got = world["ranks"][r]["no_collective"]
        assert got["step_collectives"] == 0
        assert got["step_mesh_counters"] == {}
        assert got["step_loss_rows"] == PER
        assert got["in_place"] and got["placements_kept"]
        assert got["steps"].tolist() == [3] * PER
        # local_training: only the two steps' (C,) fp32 loss gathers
        assert got["training_counters"] == {"mesh.gather.bytes": 2 * C * 4}
        assert got["losses"].shape == (2, C)


def test_meshed_route_server_routes_and_refuses_ingest_and_rounds(world):
    """Rank 0's server ingests and runs the round, and every rank ends on
    it; the followers refuse ingest and rounds, naming rank 0."""
    for r in range(RANKS):
        got = world["ranks"][r]["route_server"]
        assert got["routed"] == got["batch"]
        assert got["clock"] == got["served_clock"] == 2
        assert got["labels"].shape == (64,)
        if r == 0:
            assert got["refused"] == {}
            continue
        assert set(got["refused"]) == {"ingest", "finalize", "refinalize",
                                       "maybe_refinalize"}
        for what, msg in got["refused"].items():
            assert msg is not None and "rank 0's server" in msg, what


def test_simulate_serves_qps_on_rank_0_under_the_mesh(world):
    first = world["ranks"][0]["simulate_qps"]
    qs = first["qps_server"]
    assert qs is not None and qs["labels_equal_batch_route"]
    assert qs["errors"] == 0 and qs["timeouts"] == 0
    assert qs["batched_qps"] > 0 and qs["direct_qps"] > 0
    assert first["purity"] == 1.0
    for r in range(1, RANKS):
        other = world["ranks"][r]["simulate_qps"]
        assert other["qps_server"] is None
        np.testing.assert_array_equal(other["labels"], first["labels"])


def test_meshed_odcl_equals_the_meshed_reference(world):
    from test_torch_train_step import assert_tree_close

    got = world["ranks"][0]["ref_odcl"]
    want = world["reference"]
    assert int(want["devices"]) == RANKS     # the reference did shard
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_array_equal(got["labels"], np.arange(C) % K)
    local, post = got["metrics"][0], got["metrics"][2]
    for phase in (local, post):
        np.testing.assert_allclose(phase["client_losses"],
                                   want[f"losses_{phase['phase']}"],
                                   rtol=1e-5, atol=1e-5)
    # after 4 AdamW steps: the bounds of the reference comparisons
    # (``test_torch_federated_lm``), Adam's lr-sized moves of rounding-
    # level gradients included
    paths = sorted(got["params"])
    assert paths == sorted(k[len("params/"):] for k in want
                           if k.startswith("params/"))
    assert_tree_close({p: torch.from_numpy(got["params"][p]) for p in paths},
                      {p: want[f"params/{p}"] for p in paths},
                      move=4 * LR)


@pytest.mark.parametrize("i", range(len(SHARD_REFUSALS)))
def test_the_shard_flag_refusals_stay_as_the_reference_has_them(world, i):
    """``--shards > 1`` still refuses the mutation knobs and methods other
    than the one-shot round, in both packages."""
    from repro_torch.launch.simulate import simulate

    assert "--shards > 1" in str(world["reference"][f"refusal{i}"])
    with pytest.raises(ValueError, match="--shards > 1"):
        simulate(clients=64, clusters=2, shards=2, device="cpu",
                 **SHARD_REFUSALS[i])
