"""The port's unfused host path against the JAX reference, on the CPU: the
session's ``finalize(engine="host")``, ``one_shot_aggregate`` under the
three engines, ``odcl()``, and ``simulate`` with the logistic task,
spectral seeding and a robust aggregator.

Both packages get the same client parameters (numpy, or the reference's
own wave ERMs carried across) and the reference's JL projection.
Spectral seeding is deterministic; the ``random`` init's rows are carried
across (``interop.rows_from_numpy``).  Partitions must be identical;
parameters agree within rtol 1e-5 and atol 1e-5 * max|theta|; margins
and inertia within rtol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine.session import AggregationSession as JSession
from repro.core.federated import FederatedState as JState
from repro.core.federated import one_shot_aggregate as j_one_shot
from repro.core.odcl import odcl as jodcl
from repro.launch import simulate as jsim
from repro_torch import runtime
from repro_torch.core.engine.session import AggregationSession
from repro_torch.core.erm import batched_logistic_erm
from repro_torch.core.federated import cluster_agreement, one_shot_aggregate
from repro_torch.core.odcl import odcl
from repro_torch.interop import (
    projection_from_numpy,
    rows_from_numpy,
    state_from_numpy,
)
from repro_torch.launch.simulate import simulate

from test_torch_engine import client_thetas
from test_torch_sketch import ref_projection


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One host thread: the tensors here are small, and parallel test
    workers must not oversubscribe the CPU."""
    with runtime.pinned_threads(1):
        yield


CPU = "cpu"
C, K, DIM, S, SEED = 512, 4, 16, 32, 3


def close(got, want, scale=1.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * max(scale, 1.0))


def sessions(thetas, seed=SEED, s=S, waves=((0, 200), (200, 333))):
    """A reference and a port session fed the same keyed waves."""
    c, dim = thetas.shape
    j = JSession(c, sketch_dim=s, seed=seed)
    t = AggregationSession(c, sketch_dim=s, seed=seed, device=CPU,
                           projection=projection_from_numpy(
                               ref_projection(seed, dim, s), CPU))
    bounds = list(waves) + [(waves[-1][1], c)]
    for lo, hi in bounds:
        j.ingest({"theta": jnp.asarray(thetas[lo:hi])},
                 client_ids=list(range(lo, hi)))
        t.ingest({"theta": torch.from_numpy(thetas[lo:hi])},
                 client_ids=list(range(lo, hi)))
    return j, t


def random_rows(m, k, seed=SEED):
    """The rows the reference's ``random`` init takes under the session's
    cluster key."""
    return np.asarray(jax.random.choice(jax.random.PRNGKey(seed), m, (k,),
                                        replace=False))


def check_round(got, want, scale):
    (tstate, tlabels, tinfo), (jstate, jlabels, jinfo) = got, want
    np.testing.assert_array_equal(tlabels, np.asarray(jlabels))
    assert tinfo["n_clusters"] == jinfo["n_clusters"]
    assert tinfo["engine"] == jinfo["engine"]
    for key in ("separability_alpha", "admissible_alpha", "inertia"):
        if key in jinfo["meta"]:
            np.testing.assert_allclose(tinfo["meta"][key], jinfo["meta"][key],
                                       rtol=1e-4)
    if "n_iter" in jinfo["meta"]:
        assert tinfo["meta"]["n_iter"] == jinfo["meta"]["n_iter"]
    if jstate is None:
        assert tstate is None
        return
    close(tstate.params["theta"].numpy(), jstate.params["theta"], scale)
    # a fresh AdamW state for every client, as the reference's vmap
    opt = tstate.opt_state
    assert tuple(opt["mu"]["theta"].shape) == tuple(
        jstate.opt_state["mu"]["theta"].shape)
    assert not opt["mu"]["theta"].any() and not opt["nu"]["theta"].any()
    assert tuple(opt["step"].shape) == tuple(jstate.opt_state["step"].shape)


@pytest.mark.parametrize("algorithm,options", [
    ("spectral", None), ("kmeans-device", {"init": "spectral", "iters": 7}),
    ("kmeans", "rows"), ("kmeans-device", {"init": "random"})])
@pytest.mark.parametrize("aggregator", ["mean", "trimmed_mean", "median",
                                        "geometric_median"])
def test_session_host_round_matches_reference(algorithm, options,
                                              aggregator):
    thetas, truth = client_thetas()
    j, t = sessions(thetas)
    joptions = None if options == "rows" else options
    topts = options
    if options == "rows" or (options or {}).get("init") == "random":
        topts = {**(joptions or {}),
                 "sampler": rows_from_numpy(random_rows(C, K))}
    want = j.finalize(algorithm=algorithm, k=K, algo_options=joptions,
                      engine="host", aggregator=aggregator)
    got = t.finalize(algorithm=algorithm, k=K, algo_options=topts,
                     engine="host", aggregator=aggregator)
    check_round(got, want, float(np.abs(thetas).max()))
    assert got[2]["engine"] == "host"
    if "spectral" in (algorithm, (joptions or {}).get("init")):
        # (one random init may seed two centers in one cluster)
        assert cluster_agreement(got[1], truth) == 1.0
    # routes served from the host round's centers
    probes, _ = client_thetas(n=64, draw=1)
    np.testing.assert_array_equal(
        t.route(t.sketch_params({"theta": torch.from_numpy(probes)})),
        np.asarray(j.route(j.sketch_params({"theta": jnp.asarray(probes)}))))
    np.testing.assert_allclose(t.drift, j.drift, rtol=1e-4)


def test_session_host_convex_and_sketch_only_rounds():
    thetas, truth = client_thetas(seed=4, n=96)
    j, t = sessions(thetas, waves=((0, 40),))
    from repro.core.clustering.convex import lambda_interval

    sk = np.asarray(j.sketches)
    lo, hi = lambda_interval(sk, truth)
    opts = {"lam": 0.5 * (lo + hi), "iters": 300}
    check_round(t.finalize(algorithm="convex", algo_options=opts,
                           engine="host"),
                j.finalize(algorithm="convex", algo_options=opts,
                           engine="host"), float(np.abs(thetas).max()))
    # sketch-only sessions: labels and centers, no parameters
    js = JSession(96, sketch_dim=S, seed=SEED)
    ts = AggregationSession(96, sketch_dim=S, seed=SEED, device=CPU)
    js.ingest(sketches=jnp.asarray(sk))
    ts.ingest(sketches=torch.from_numpy(sk))
    got = ts.finalize(algorithm="spectral", k=K, engine="host")
    check_round(got, js.finalize(algorithm="spectral", k=K, engine="host"),
                1.0)
    assert ts.route(sk[5]) == got[1][5]


def test_session_host_engine_guards():
    thetas, _ = client_thetas(seed=5, n=64)
    _, t = sessions(thetas, waves=((0, 30),))
    with pytest.raises(ValueError, match="init='warm'"):
        t.finalize(algorithm="kmeans-device", k=K, engine="host",
                   algo_options={"init": "warm"})
    _, labels, info = t.finalize(algorithm="gradient-device", k=K,
                                 engine="host", algo_options={"iters": 30})
    assert info["engine"] == "host" and info["n_clusters"] == K
    # the host span carries the reference's fields
    from repro_torch import obs

    sink = obs.add_sink(obs.ListSink())
    try:
        t.finalize(algorithm="spectral", k=K, engine="host")
    finally:
        obs.remove_sink(sink)
    spans = {e["name"]: e for e in sink.events if e["event"] == "span"}
    assert spans["session.finalize"]["engine"] == "host"
    assert spans["session.finalize"]["algorithm"] == "spectral"
    assert spans["session.finalize"]["count"] == 64
    assert spans["session.finalize.cluster"]["parent"] == "session.finalize"
    # staleness weights take only the mean, on both engines
    from repro_torch.core.engine.staleness import make_staleness_policy

    t.staleness = make_staleness_policy("exp_decay=2.0")
    t.ingest({"theta": torch.from_numpy(thetas[:3])}, client_ids=[0, 1, 2])
    for engine in ("host", "device"):
        with pytest.raises(ValueError, match="'mean' aggregator"):
            t.finalize(algorithm="spectral", k=K, engine=engine,
                       aggregator="median")
    _, labels, _ = t.finalize(algorithm="spectral", k=K, engine="host")
    assert len(labels) == 64


def fed_pair(thetas):
    return (JState(params={"theta": jnp.asarray(thetas)}, opt_state=None,
                   n_clients=len(thetas)),
            state_from_numpy({"theta": thetas}, CPU))


@pytest.mark.parametrize("engine,algorithm,options", [
    ("host", "spectral", None), ("host", "kmeans-device", {"init": "spectral"}),
    ("auto", "spectral", {"iters": 9}),
    ("device", "kmeans-device", {"init": "spectral"}),
    ("auto", "kmeans-device", {"init": "spectral", "restarts": 3}),
    ("host", "kmeans", "rows")])
def test_one_shot_aggregate_engines_match_reference(engine, algorithm,
                                                    options):
    thetas, truth = client_thetas(seed=6)
    jstate, tstate = fed_pair(thetas)
    jopts = None if options == "rows" else options
    topts = ({"sampler": rows_from_numpy(random_rows(C, K, SEED))}
             if options == "rows" else options)
    want = j_one_shot(jstate, None, algorithm=algorithm, k=K,
                      algo_options=jopts, sketch_dim=S, seed=SEED,
                      engine=engine, aggregator="trimmed_mean",
                      return_sketches=True)
    got = one_shot_aggregate(
        tstate, algorithm=algorithm, k=K, algo_options=topts, sketch_dim=S,
        seed=SEED, engine=engine, aggregator="trimmed_mean",
        projection=projection_from_numpy(ref_projection(SEED, DIM, S), CPU),
        return_sketches=True, device=CPU)
    close(got[2]["sketches"], want[2]["sketches"])
    if got[2]["engine"] == "host":
        check_round(got, want, float(np.abs(thetas).max()))
    else:
        np.testing.assert_array_equal(got[1], np.asarray(want[1]))
        close(got[0].params["theta"].numpy(), want[0].params["theta"],
              float(np.abs(thetas).max()))
    assert got[2]["engine"] == want[2]["engine"]
    if options != "rows":
        assert cluster_agreement(got[1], truth) == 1.0


def test_one_shot_aggregate_engine_choice():
    thetas, _ = client_thetas(seed=7, n=96)
    _, tstate = fed_pair(thetas)
    kw = dict(k=K, sketch_dim=S, seed=SEED, device=CPU)
    assert one_shot_aggregate(tstate, algorithm="spectral",
                              **kw)[2]["engine"] == "host"
    assert one_shot_aggregate(tstate, algorithm="gradient",
                              **kw)[2]["engine"] == "device"
    # the Definition-1 margin is a host-side figure
    _, _, info = one_shot_aggregate(tstate, algorithm="kmeans-device",
                                    assert_separable=True, **kw)
    assert info["engine"] == "host"
    with pytest.raises(ValueError, match="assert_separable"):
        one_shot_aggregate(tstate, algorithm="kmeans-device",
                           assert_separable=True, engine="device", **kw)
    with pytest.raises(ValueError, match="host-only"):
        one_shot_aggregate(tstate, algorithm="spectral", engine="device",
                           **kw)
    with pytest.raises(ValueError, match="auto\\|host\\|device"):
        one_shot_aggregate(tstate, algorithm="spectral", engine="tpu", **kw)


@pytest.mark.parametrize("algorithm,aggregator,options", [
    ("spectral", "mean", {}), ("spectral", "median", {"iters": 4}),
    ("kmeans", "trimmed_mean", "rows"),
    ("kmeans-device", "geometric_median", {"init": "spectral"})])
def test_odcl_matches_reference(algorithm, aggregator, options):
    thetas, truth = client_thetas(seed=8, n=240)
    jopts = {} if options == "rows" else options
    topts = ({"sampler": rows_from_numpy(random_rows(240, K, 2))}
             if options == "rows" else options)
    want = jodcl(thetas, algorithm=algorithm, k=K, seed=2,
                 aggregator=aggregator, **jopts)
    got = odcl(thetas, algorithm=algorithm, k=K, seed=2,
               aggregator=aggregator, device=CPU, **topts)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.n_clusters == want.n_clusters == K
    scale = float(np.abs(thetas).max())
    close(got.cluster_models, want.cluster_models, scale)
    close(got.user_models, want.user_models, scale)
    for key in ("separability_alpha", "admissible_alpha"):
        np.testing.assert_allclose(got.meta[key], want.meta[key], rtol=1e-4)
    if algorithm != "kmeans":
        assert cluster_agreement(got.labels, truth) == 1.0
    with pytest.raises(ValueError, match="not separable"):
        odcl(thetas + np.random.default_rng(0).normal(
            size=thetas.shape).astype(np.float32) * 50.0,
            algorithm="spectral", k=K, device=CPU, assert_separable=True)


# ------------------------------------------- simulate's new paths

def reference_wave(task, c, k=8, d=16, n=64, seed=0):
    """The reference simulate's first wave: its optima, labels, the
    (x, y) it draws, and its local models (``_wave_erm``)."""
    key = jax.random.PRNGKey(seed)
    k_opt, k_data = jax.random.split(key)
    optima = jsim.staggered_optima(k_opt, k, d)
    labels = jnp.arange(c, dtype=jnp.int32) % k
    wkey = jax.random.fold_in(k_data, 0)
    thetas = jsim._wave_erm(wkey, optima, labels, wave=c, n=n, d=d, task=task)
    kx, ke = jax.random.split(wkey)
    x = jax.random.normal(kx, (c, n, d), jnp.float32)
    z = jnp.einsum("wnd,wd->wn", x, optima[labels])
    y = 2.0 * (jax.random.uniform(ke, (c, n)) <
               jax.nn.sigmoid(z)).astype(jnp.float32) - 1.0
    return np.array(thetas), np.asarray(x), np.asarray(y), np.asarray(labels)


@pytest.mark.parametrize("init,aggregator", [("spectral", "mean"),
                                             ("spectral", "trimmed_mean"),
                                             ("spectral", "median")])
def test_logistic_round_matches_reference(init, aggregator):
    """simulate's logistic task, through both packages: the port's Newton
    on the reference's (x, y), then the same session round."""
    c = 1024
    want_thetas, x, y, truth = reference_wave("logistic", c)
    thetas = batched_logistic_erm(torch.from_numpy(x), torch.from_numpy(y),
                                  1e-6, 8).numpy()
    close(thetas, want_thetas, float(np.abs(want_thetas).max()) * 10.0)
    j, t = sessions(want_thetas, seed=0, s=64, waves=((0, 400),))
    opts = {"init": init, "iters": 50, "aggregator": aggregator}
    jout = j.finalize(algorithm="kmeans-device", k=8, algo_options=opts,
                      aggregator=aggregator)
    tout = t.finalize(algorithm="kmeans-device", k=8, algo_options=opts,
                      aggregator=aggregator)
    np.testing.assert_array_equal(tout[1], np.asarray(jout[1]))
    close(tout[0].params["theta"].numpy(), jout[0].params["theta"],
          float(np.abs(want_thetas).max()))
    # the port's own thetas give the same partition
    _, t2 = sessions(thetas, seed=0, s=64, waves=((0, 400),))
    np.testing.assert_array_equal(
        t2.finalize(algorithm="kmeans-device", k=8, algo_options=opts,
                    aggregator=aggregator)[1], tout[1])
    assert tout[2]["n_clusters"] == 8


@pytest.mark.parametrize("flags", [
    {"task": "logistic"}, {"init": "spectral"},
    {"aggregator": "trimmed_mean", "trim_beta": 0.2},
    {"init": "spectral", "aggregator": "geometric_median"},
    {"algorithm": "gradient-device"}, {"algorithm": "spectral"},
    {"init": "random", "aggregator": "median", "restarts": 3}],
    ids=["logistic", "spectral", "trimmed", "spectral-geomedian",
         "gradient-device", "spectral-name", "random-median"])
def test_simulate_new_paths_against_reference(flags):
    want = jsim.simulate(clients=1024, clusters=8, wave=400, **flags)
    got = simulate(clients=1024, clusters=8, wave=400, device=CPU, **flags)
    for key in ("task", "aggregator", "clients", "n_clusters_recovered"):
        assert got[key] == want[key], key
    if flags.get("task") == "logistic":
        # neither recovers the planted clusters: 64 samples leave the
        # logistic models' clusters overlapping (separability < 1)
        assert got["mse"] is None and want["mse"] is None
        assert 0.5 < got["purity"] <= 1.0
    elif flags.get("init") == "random":
        # random seeds may share a cluster, in either package
        assert got["purity"] > 0.5 and want["purity"] > 0.5
    else:
        assert got["purity"] == want["purity"] == 1.0
        assert got["mse"] < 1e-2 and want["mse"] < 1e-2
