"""Algorithm 1 over deep-model federations: the port's streamed sketch,
``core/federated.py`` and ``core/federated_methods.py`` against the JAX
reference, on the reference tests' tiny config (qwen2-0.5b reduced to 1
layer, d 64, vocab 64, fp32), C = 4 clients, K = 2, batch 2, seq 16.

The reference's draws are carried across: the stacked parameters and
AdamW state (``interop.federation_from_numpy``), the JL projection
(``ref_projection``, or block by block), IFCA's ``perturb`` noise.  The
clustering seeds are each package's own, so the federation is planted:
two reference inits, each client one of them plus 1e-2 noise, which every
seeding splits the same way.  Partitions must be equal (up to renaming
where the seeds differ, exactly where a rule is deterministic); models
within 1e-5 of their largest magnitude, after AdamW steps within the
bounds of ``test_torch_train_step.assert_tree_close``; comm bytes, comm
rounds and the ``fed.*`` obs counters and events equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.federated import FederatedState as JState
from repro.core.federated import cluster_average_tree as jcluster_average
from repro.core.federated import cluster_mean_tree as jcluster_mean
from repro.core.federated import evaluate_per_client as jevaluate
from repro.core.federated import one_shot_aggregate as jone_shot
from repro.core.federated_methods import (
    build_federated_method as jbuild,
    list_federated_methods as jlist,
)
from repro.core.sketch import sketch_tree as jsketch_tree
from repro.data import ClusteredTokenStream as JStream
from repro.data import make_lm_batch_iterator as jbatches
from repro.models import init_params as jinit_params
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro_torch import obs, runtime
from repro_torch.core import federated as tfed
from repro_torch.core import sketch as tsketch
from repro_torch.core.engine import session as tsession
from repro_torch.core.engine.session import AggregationSession
from repro_torch.core.federated_methods import (
    FederatedMethodResult,
    build_federated_method,
    get_federated_method,
    list_federated_methods,
    register_federated_method,
    unregister_federated_method,
)
from repro_torch.data import ClusteredTokenStream, make_lm_batch_iterator
from repro_torch.interop import (
    federation_from_numpy,
    params_from_numpy,
    perturb_noise_from_numpy,
    projection_from_numpy,
)
from repro_torch.optim import AdamWConfig
from repro_torch.utils import tree_leaves, tree_map, tree_to_matrix

from conftest import same_partition
from test_torch_sketch import ref_projection
from test_torch_train_step import assert_tree_close, numpy_tree, tiny_cfgs

CPU = "cpu"
C, K, BATCH, SEQ, S = 4, 2, 2, 16, 32
OPT = dict(lr=1e-3, weight_decay=0.0)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One host thread: the tensors here are small, and parallel test
    workers must not oversubscribe the CPU."""
    with runtime.pinned_threads(1):
        yield


def planted(seed=0, c=C, noise=1e-2):
    """(reference state, numpy params, numpy opt state): clients 0..c/2-1
    are reference init ``seed`` plus noise, the others init ``seed + 1``
    plus noise."""
    jcfg = tiny_cfgs()[0]
    a, b = (numpy_tree(jinit_params(jax.random.PRNGKey(seed + i), jcfg))
            for i in range(2))
    rng = np.random.default_rng(seed)

    def stack(la, lb):
        base = np.stack([la if i < c // 2 else lb for i in range(c)])
        return (base + noise * rng.normal(size=base.shape)).astype(
            np.float32)

    params = jax.tree_util.tree_map(stack, a, b)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    opt = jax.vmap(jadamw_init)(jparams)
    return (JState(params=jparams, opt_state=opt, n_clients=c), params,
            numpy_tree(opt))


def port_state(params, opt):
    return federation_from_numpy(params, opt, device=CPU)


def n_per_client(params):
    return int(sum(np.prod(l.shape[1:])
                   for l in jax.tree_util.tree_leaves(params)))


def batch_iters(seed=0):
    """The same token batches for both packages."""
    kw = dict(n_clients=C, n_clusters=K, vocab_size=64, seed=seed,
              branching=4)
    its = []
    for stream, make in ((JStream(**kw), jbatches),
                         (ClusteredTokenStream(**kw), make_lm_batch_iterator)):
        raw = make(stream, clients_per_batch=list(range(C)),
                   per_client_batch=BATCH, seq_len=SEQ)
        its.append({"tokens": t, "labels": l} for t, l in raw)
    return its


def assert_models_close(got, want, steps=0):
    """Within 1e-5 of the largest magnitude; after ``steps`` AdamW steps,
    also the bounds of ``assert_tree_close`` (Adam normalizes rounding
    noise in near-zero gradients up to lr-sized steps)."""
    assert_tree_close(got, want, move=steps * OPT["lr"] if steps else None)


# ------------------------------------------------------- the streamed sketch

def straddling_stack(rng, c, n):
    """A stacked tree of n values a client whose leaves straddle the
    65 536-row blocks (sizes 70 001, 60 000, the rest)."""
    sizes = [70_001, 60_000, n - 130_001]
    return {name: rng.normal(size=(c, m)).astype(np.float32)
            for name, m in zip(("a", "b", "c"), sizes)}


N_LONG = 3 * (1 << 16) + 17


def test_streamed_sketch_equals_the_materialized_one():
    stack = params_from_numpy(straddling_stack(np.random.default_rng(0), 3,
                                               N_LONG), CPU)
    got = tsketch.sketch_stacked(stack, sketch_dim=8, seed=5)
    proj = tsketch.jl_projection(N_LONG, 8, seed=5, device=CPU)
    want = tsketch.sketch_rows(tree_to_matrix(stack), proj)
    # one n-term product against four block products summed
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))
    # one client alone, streamed, is its row
    one = tsketch.sketch_tree(tree_map(lambda l: l[1], stack), 8, seed=5)
    np.testing.assert_allclose(one.numpy(), got[1].numpy(), rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


def test_streamed_sketch_equals_reference_with_its_blocks():
    """The reference's draws carried across: block i is
    normal(fold_in(key, i), (65 536, s)) over sqrt(s), the blocks
    concatenated and cut to n rows."""
    seed, s = 3, 16
    rng = np.random.default_rng(1)
    stack = straddling_stack(rng, 2, N_LONG)
    key = jax.random.PRNGKey(seed)
    blocks = [jax.random.normal(jax.random.fold_in(key, i), (1 << 16, s),
                                jnp.float32)
              for i in range(-(-N_LONG // (1 << 16)))]
    proj = np.array(jnp.concatenate(blocks)[:N_LONG]
                      / jnp.sqrt(jnp.float32(s)))
    got = tsketch.sketch_stacked(params_from_numpy(stack, CPU),
                                 torch.from_numpy(proj))
    want = np.asarray(jax.vmap(lambda p: jsketch_tree(key, p, s))(
        jax.tree_util.tree_map(jnp.asarray, stack)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def test_shallow_sketch_is_unchanged_bit_for_bit():
    stack = params_from_numpy({"w": np.random.default_rng(2).normal(
        size=(5, 300, 7)).astype(np.float32), "b": np.ones((5, 9), np.float32)},
        CPU)
    proj = tsketch.jl_projection(2109, 24, seed=9, device=CPU)
    want = tree_to_matrix(stack) @ proj
    assert torch.equal(tsketch.sketch_stacked(stack, sketch_dim=24, seed=9),
                       want)
    assert torch.equal(tsketch.sketch_stacked(stack, proj), want)
    sess = AggregationSession(5, sketch_dim=24, seed=9, device=CPU)
    sess.ingest(stack)
    assert torch.equal(sess.sketches, want)


def test_no_round_materializes_a_long_projection(monkeypatch):
    """Past one block, the rounds and the session stream S: a call for
    the whole (n, s) projection fails the test."""
    def refuse(n, *a, **kw):
        raise AssertionError(f"materialized a ({n}, s) projection")

    monkeypatch.setattr(tsketch, "jl_projection", refuse)
    monkeypatch.setattr(tsession, "jl_projection", refuse)
    rng = np.random.default_rng(3)
    stack = straddling_stack(rng, 4, N_LONG)
    stack["c"][2:] += 3.0
    state = federation_from_numpy(stack, device=CPU)
    _, host_labels, info = tfed.one_shot_aggregate(
        state, None, algorithm="kmeans++", k=2, sketch_dim=8, seed=1,
        engine="host", return_sketches=True, device=CPU)
    _, dev_labels, dinfo = tfed.one_shot_aggregate(
        state, None, algorithm="kmeans-device", k=2, sketch_dim=8, seed=1,
        engine="device", return_sketches=True, device=CPU)
    assert same_partition(host_labels, [0, 0, 1, 1])
    assert same_partition(dev_labels, [0, 0, 1, 1])
    np.testing.assert_array_equal(info["sketches"], dinfo["sketches"])
    sess = AggregationSession(4, sketch_dim=8, seed=1, device=CPU)
    sess.ingest(state.params)
    np.testing.assert_array_equal(sess.sketches.numpy(), info["sketches"])
    sess.finalize(k=2)
    assert sess.route(params=tree_map(lambda l: l[3], state.params)) == \
        sess.route(sess.sketches[3])


# ------------------------------------------------------------ one round

@pytest.mark.parametrize("engine,algorithm", [("host", "kmeans++"),
                                              ("device", "kmeans-device"),
                                              ("auto", "kmeans++")])
def test_one_shot_aggregate_with_cfg_matches_reference(engine, algorithm):
    jstate, params, opt = planted(0)
    jcfg, tcfg = tiny_cfgs()
    n = n_per_client(params)
    jnew, jlabels, _ = jone_shot(jstate, jcfg, algorithm=algorithm, k=K,
                                 sketch_dim=S, seed=4, engine=engine)
    # moments of ones: the round must leave the caller's state as it was
    opt = jax.tree_util.tree_map(np.ones_like, opt)
    state = port_state(params, opt)
    kept = [t.clone() for t in tree_leaves((state.params, state.opt_state))]
    proj = projection_from_numpy(ref_projection(4, n, S), CPU)
    new, labels, info = tfed.one_shot_aggregate(
        state, tcfg, algorithm=algorithm, k=K, sketch_dim=S, seed=4,
        engine=engine, device=CPU, projection=proj)
    assert same_partition(labels, jlabels)
    assert same_partition(labels, [0, 0, 1, 1])
    assert_models_close(new.params, jnew.params)
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves((state.params, state.opt_state)), kept))
    # the moments stay with their owner; a state without them gets the
    # reference's fresh adamw_init
    assert new.opt_state is None
    bare, _, _ = tfed.one_shot_aggregate(
        state._replace(opt_state=None), tcfg, algorithm=algorithm, k=K,
        sketch_dim=S, seed=4, engine=engine, device=CPU, projection=proj)
    want = numpy_tree(jnew.opt_state)
    got = numpy_tree(bare.opt_state)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape and not g.any() and not w.any()


def test_cluster_trees_and_evaluation_match_reference():
    jstate, params, opt = planted(1)
    jcfg, tcfg = tiny_cfgs()
    labels = np.array([1, 0, 1, 1])
    onehot = np.eye(2, dtype=np.float32)[labels]
    counts = onehot.sum(0)
    state = port_state(params, opt)
    for jf, tf in ((jcluster_mean, tfed.cluster_mean_tree),
                   (jcluster_average, tfed.cluster_average_tree)):
        want = jf(jstate.params, jnp.asarray(onehot), jnp.asarray(counts))
        got = tf(state.params, torch.from_numpy(onehot),
                 torch.from_numpy(counts))
        assert_models_close(got, want)
    it = batch_iters()
    jb, tb = next(it[0]), next(it[1])
    np.testing.assert_allclose(tfed.evaluate_per_client(state, tcfg, tb),
                               jevaluate(jstate, jcfg, jb), rtol=1e-5)


# the one-hot rows of a 4-client, 3-cluster gather-back: the last row has
# no cluster (all zero) or a soft one-hot (0.25 / 0.75)
GATHER_ROWS = {"zero row": [0.0, 0.0, 0.0],
               "soft row": [0.25, 0.0, 0.75]}


@pytest.mark.parametrize("row", sorted(GATHER_ROWS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cluster_average_tree_matches_reference_off_one_hot(row, dtype):
    """``onehot @ means`` on a row that is not one-hot: zeros where it sums
    to 0, the product where it is soft; one-hot rows keep their mean."""
    rng = np.random.default_rng(3)
    onehot = np.eye(3, dtype=np.float32)[[0, 1, 2, 0]]
    onehot[3] = GATHER_ROWS[row]
    counts = np.maximum(onehot.sum(0), 1.0).astype(np.float32)
    tree = {"w": np.arange(12, dtype=np.float32).reshape(4, 3),
            "b": rng.normal(size=(4, 2, 5)).astype(np.float32)}
    jtree = {k: jnp.asarray(v, dtype) for k, v in tree.items()}
    want = jcluster_average(jtree, jnp.asarray(onehot), jnp.asarray(counts))
    got = tfed.cluster_average_tree(
        {k: torch.from_numpy(v).to(getattr(torch, dtype))
         for k, v in tree.items()},
        torch.from_numpy(onehot), torch.from_numpy(counts))
    for key in tree:
        w = np.asarray(want[key].astype(jnp.float32))
        g = got[key].float().numpy()
        assert got[key].dtype == getattr(torch, dtype)
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
        if row == "zero row":
            assert not g[3].any()


def test_init_federation_stacks_one_or_several_inits():
    _, tcfg = tiny_cfgs()
    same = tfed.init_federation(0, tcfg, 3, device=CPU)
    for l in tree_leaves(same.params):
        assert l.shape[0] == 3 and torch.equal(l[0], l[2])
    assert same.opt_state["step"].shape == (3,)
    apart = tfed.init_federation(0, tcfg, 3, same_init=False, device=CPU)
    emb = apart.params["embed"]
    assert torch.equal(emb[0], same.params["embed"][0])
    assert not torch.equal(emb[0], emb[1])


# -------------------------------------------------------------- methods

def test_registry_matches_reference():
    assert list_federated_methods() == jlist() == (
        "fedavg", "ifca", "local-only", "odcl")
    m = build_federated_method("ifca", k=3, rounds=2, post_steps=9,
                               engine=None)
    assert (m.k, m.rounds, m.name) == (3, 2, "ifca")

    class Noop:
        name = "noop"

        def run(self, key, state, cfg, batches=None):
            return FederatedMethodResult(state, np.zeros(state.n_clients),
                                         1, 0.0, 0.0, [], {})

    register_federated_method(Noop)
    try:
        assert get_federated_method("noop") is Noop
        with pytest.raises(ValueError, match="already registered"):
            register_federated_method(Noop)
    finally:
        unregister_federated_method("noop")
    with pytest.raises(KeyError, match="unknown federated method"):
        get_federated_method("noop")


def run_both(name, seed=0, **kw):
    """One method on the planted federation in both packages, from the
    same batches.  Returns (reference result, port result)."""
    jstate, params, opt = planted(seed)
    jcfg, tcfg = tiny_cfgs()
    jit, tit = batch_iters(seed)
    proj = projection_from_numpy(
        ref_projection(kw.get("seed", 0), n_per_client(params),
                       kw.get("sketch_dim", S)), CPU)
    extra = {"projection": proj} if name in ("odcl", "ifca") else {}
    noise = kw.pop("perturb_noise", None)
    if noise is not None:
        extra["perturb_noise"] = perturb_noise_from_numpy(noise, CPU)
    jres = jbuild(name, opt=JAdamWConfig(**OPT), **kw).run(
        jax.random.PRNGKey(seed), jstate, jcfg, jit)
    obs.reset()
    sink = obs.add_sink(obs.ListSink())
    try:
        tres = build_federated_method(name, opt=AdamWConfig(**OPT), **kw,
                                      **extra).run(
            seed, port_state(params, opt), tcfg, tit)
    finally:
        obs.remove_sink(sink)
    tres.meta["events"] = [e for e in sink.events
                           if e["event"] == "fed.round"]
    return jres, tres


@pytest.mark.parametrize("engine,algorithm", [("host", "kmeans++"),
                                              ("device", "kmeans++")])
def test_odcl_matches_reference(engine, algorithm):
    jres, tres = run_both("odcl", algorithm=algorithm, k=K, engine=engine,
                          sketch_dim=S, local_steps=2, post_steps=1)
    assert same_partition(tres.labels, jres.labels)
    assert tres.n_clusters == jres.n_clusters == 2
    assert tres.comm_bytes == jres.comm_bytes and tres.comm_rounds == 1.0
    assert tres.state.step == jres.state.step == 3
    assert_models_close(tres.state.params, jres.state.params, steps=3)
    for got, want in zip(tres.round_metrics, jres.round_metrics):
        for key in ("loss_first", "loss_last"):
            if key in want:
                assert abs(got[key] - want[key]) <= 1e-5 * want[key]
    snap = obs.snapshot()
    assert snap["counters"]["fed.comm_bytes"] == tres.comm_bytes
    assert snap["histograms"]["fed.round.ms"]["count"] == 1
    (event,) = tres.meta["events"]
    assert (event["round"], event["bytes"], event["n_clusters"]) == (
        0, tres.comm_bytes, 2)


def reference_perturb_noise(seed, jstate, k):
    """The reference's ``perturb`` draws: one normal a leaf, keys
    ``split(PRNGKey(seed), n_leaves)``."""
    leaves = jax.tree_util.tree_leaves(jstate.params)
    subs = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    noise = [np.asarray(jax.random.normal(sub, (k,) + l.shape[1:], l.dtype))
             for sub, l in zip(subs, leaves)]
    it = iter(noise)
    return jax.tree_util.tree_map(lambda _: next(it), jstate.params)


@pytest.mark.parametrize("assign,init,carry", [
    ("loss", "clients", False), ("loss", "perturb", True),
    ("sketch", "clients", True), ("sketch", "perturb", False)])
def test_ifca_matches_reference(assign, init, carry):
    kw = dict(k=K, rounds=2, local_steps=1, assign=assign, init=init,
              carry_opt_state=carry, sketch_dim=S)
    if init == "perturb":
        kw["perturb_noise"] = reference_perturb_noise(0, planted(0)[0], K)
    jres, tres = run_both("ifca", **kw)
    np.testing.assert_array_equal(tres.labels, jres.labels)
    assert [r["assign_churn"] for r in tres.round_metrics] == \
        [r["assign_churn"] for r in jres.round_metrics]
    assert tres.comm_bytes == jres.comm_bytes and tres.comm_rounds == 2.0
    assert_models_close(tres.state.params, jres.state.params, steps=2)
    assert obs.snapshot()["counters"]["fed.comm_bytes"] == tres.comm_bytes
    events = tres.meta["events"]
    assert [e["round"] for e in events] == [0, 1]
    assert all(e["bytes"] == tres.comm_bytes / 2 and e["clients"] == C
               and e["method"] == "ifca" for e in events)
    assert [e["churn"] for e in events] == \
        [r["assign_churn"] for r in jres.round_metrics]


def test_ifca_without_local_steps_serves_cluster_models():
    jres, tres = run_both("ifca", k=K, rounds=2, local_steps=0,
                          assign="sketch", init="clients", sketch_dim=S)
    np.testing.assert_array_equal(tres.labels, jres.labels)
    assert_models_close(tres.state.params, jres.state.params)
    with pytest.raises(ValueError, match="rounds >= 1"):
        build_federated_method("ifca", rounds=0).run(0, None, None)


def test_fedavg_and_local_only_match_reference():
    jres, tres = run_both("fedavg", rounds=2, local_steps=1)
    assert tres.n_clusters == 1 and tres.comm_bytes == jres.comm_bytes
    assert tres.labels.tolist() == [0] * C
    assert_models_close(tres.state.params, jres.state.params, steps=2)
    jres, tres = run_both("local-only", local_steps=2)
    assert tres.comm_bytes == 0.0 and tres.labels.tolist() == list(range(C))
    assert_models_close(tres.state.params, jres.state.params, steps=2)


def test_moe_cfg_sketches_the_router_invariant_leaves():
    """An MoE config sketches the dense leaves and the router, not the
    per-expert ``moe`` weights, in the round and in the session."""
    import types

    rng = np.random.default_rng(5)
    params = {"embed": rng.normal(size=(4, 6)),
              "layers": {"moe": {"router": rng.normal(size=(4, 3)),
                                 "w_in": rng.normal(size=(4, 5)),
                                 "w_out": rng.normal(size=(4, 2))}}}
    params = jax.tree_util.tree_map(lambda a: a.astype(np.float32), params)
    moe = types.SimpleNamespace(is_moe=True)
    jstate = JState(params=jax.tree_util.tree_map(jnp.asarray, params),
                    opt_state=None, n_clients=4)
    _, _, jinfo = jone_shot(jstate, moe, algorithm="kmeans++", k=2,
                            sketch_dim=8, seed=2, engine="host",
                            return_sketches=True)
    proj = projection_from_numpy(ref_projection(2, 9, 8), CPU)
    state = federation_from_numpy(params, device=CPU)
    _, _, info = tfed.one_shot_aggregate(
        state, moe, algorithm="kmeans++", k=2, sketch_dim=8, engine="host",
        projection=proj, return_sketches=True, device=CPU)
    np.testing.assert_allclose(info["sketches"], jinfo["sketches"],
                               rtol=1e-5, atol=1e-6)
    sess = AggregationSession(4, sketch_dim=8, projection=proj, cfg=moe,
                              device=CPU)
    sess.ingest(state.params)
    np.testing.assert_array_equal(sess.sketches.numpy(), info["sketches"])
    with pytest.raises(ValueError, match="projection"):
        tfed.one_shot_aggregate(state, None, algorithm="kmeans++", k=2,
                                sketch_dim=8, engine="host",
                                projection=proj, device=CPU)
