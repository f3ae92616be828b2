"""The port's public surface against the reference's, on the CPU.

* Every name of each reference package's ``__all__`` resolves in the
  port's package of the same path, and every public function and class
  (with its public methods) of each reference module resolves in the
  port's module of the same path, but for exactly the XLA-only names of
  ``NOT_PORTED``.  The reference's ``kernels/ref.py`` oracles are each
  kernel module's ``<name>_ref`` in the port.
* ``import repro_torch.core`` (and ``.core.engine``) loads neither the
  model stack, nor ``federated_methods``, nor the session: those names
  load on first use, as the reference's do.
* ``examples/quickstart.py``'s calls through ``repro_torch.core`` give the
  reference quickstart's partitions (the same partition up to renaming;
  the true one for every method that clusters) and nmse within rtol 1e-4.
* ``utils.key_fold`` and ``utils.split_like`` derive keys as the
  reference's do, over the port's integer keys.
* Every registered algorithm, edge set and aggregator is an instance of
  its ``runtime_checkable`` protocol, and the registries still take a
  duck-typed plug-in.
"""
import ast
import importlib
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.utils import split_like as jsplit_like
from repro_torch import runtime

from conftest import same_partition

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"

# exist only for XLA (ROADMAP queue A's "not to port" list): the runtime's
# XLA flag and platform helpers, the AOT program cache, the HLO collective
# parser, and the Pallas entry points (whose kernels are hand-written
# CUDA in the port)
NOT_PORTED = frozenset({
    "add_xla_flags", "merge_xla_flags", "set_host_device_count",
    "set_platform", "enable_x64", "jax_imported", "cached_program",
    "collective_bytes_from_hlo"})
# kernels/ref.py's oracles -> the port module holding each plain version
REF_ORACLES = {"pairwise_sqdist": "pairwise_l2",
               "kmeans_assign": "kmeans_assign",
               "group_ball_proj": "group_prox",
               "group_ball_proj_batched": "group_prox",
               "flash_attention": "flash_attention"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One host thread: the tensors here are small, and parallel test
    workers must not oversubscribe the CPU."""
    with runtime.pinned_threads(1):
        yield


def not_ported(name: str) -> bool:
    return name in NOT_PORTED or name.endswith("_pallas")


def module_name(path: Path) -> str:
    parts = path.relative_to(REF.parent).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def port_name(module: str) -> str:
    return "repro_torch" + module[len("repro"):]


def public_defs(path: Path) -> dict:
    """Top-level public functions and classes of a module (AST, no
    import): {name: [public method names]}."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and \
                not node.name.startswith("_"):
            out[node.name] = [m.name for m in getattr(node, "body", [])
                              if isinstance(node, ast.ClassDef)
                              and isinstance(m, ast.FunctionDef)
                              and not m.name.startswith("_")]
    return out


def ref_all(path: Path):
    """The module's literal ``__all__`` (and its ``+=`` additions)."""
    names = None
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            names = list(ast.literal_eval(node.value))
        elif isinstance(node, ast.AugAssign) and \
                getattr(node.target, "id", None) == "__all__":
            names = None                      # computed: import the module
    return names


REF_MODULES = sorted(REF.rglob("*.py"))
PACKAGES = [p for p in REF_MODULES if "__all__" in p.read_text()]


@pytest.mark.parametrize("path", PACKAGES, ids=module_name)
def test_every_name_of_the_reference_all_resolves(path):
    module = module_name(path)
    names = ref_all(path)
    if names is None:
        names = list(importlib.import_module(module).__all__)
    port = importlib.import_module(port_name(module))
    missing = [n for n in names if not hasattr(port, n) and not not_ported(n)]
    assert not missing, f"{port.__name__} lacks {missing}"


@pytest.mark.parametrize("path", REF_MODULES, ids=module_name)
def test_every_public_definition_of_the_reference_resolves(path):
    module = module_name(path)
    missing = []
    for name, methods in public_defs(path).items():
        if not_ported(name):
            continue
        if module == "repro.kernels.ref":
            owner = importlib.import_module(
                f"repro_torch.kernels.{REF_ORACLES[name]}")
            obj = getattr(owner, f"{name}_ref", None)
        else:
            obj = getattr(importlib.import_module(port_name(module)), name,
                          None)
        if obj is None:
            missing.append(name)
            continue
        missing += [f"{name}.{m}" for m in methods if not hasattr(obj, m)]
    assert not missing, f"{port_name(module)} lacks {missing}"


def test_the_exclusions_are_exactly_the_xla_only_names():
    """Each excluded name is defined in the reference and absent from
    every port module: the list hides nothing that was ported."""
    defined = {n for p in REF_MODULES for n in public_defs(p)}
    excluded = {n for n in defined if not_ported(n)}
    assert NOT_PORTED <= defined
    assert excluded - NOT_PORTED == {
        "flash_attention_pallas", "group_ball_proj_pallas",
        "group_ball_proj_batched_pallas", "kmeans_assign_pallas",
        "pairwise_sqdist_pallas"}
    port_src = "\n".join(p.read_text() for p in
                         (ROOT / "src" / "repro_torch").rglob("*.py"))
    for name in excluded:
        assert f"def {name}(" not in port_src, name


LAZY_PROBE = """
import sys
import repro_torch.core, repro_torch.core.engine
heavy = ("repro_torch.models", "repro_torch.core.federated_methods",
         "repro_torch.core.engine.session")
print([m for m in heavy if m in sys.modules])
repro_torch.core.ODCLFederated, repro_torch.core.engine.AggregationSession
print([m for m in heavy if m in sys.modules])
"""


def test_light_imports_stay_light():
    """``repro_torch.core`` loads the model stack, the LM methods and the
    session only when one of their names is first used."""
    out = subprocess.run([sys.executable, "-c", LAZY_PROBE],
                         capture_output=True, text=True, check=True,
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")}, timeout=120)
    before, after = out.stdout.strip().splitlines()
    assert before == "[]"
    assert "repro_torch.core.federated_methods" in after
    assert "repro_torch.core.engine.session" in after


# ------------------------------------------------------------ quickstart

QUICKSTART = ["odcl-kmeans++", "odcl-clusterpath", "oracle-averaging",
              "local-only", "global-erm"]


def quickstart_method(pkg, name, fed, **kw):
    """examples/quickstart.py's methods, built from ``pkg`` (the
    reference's ``repro.core`` or the port's ``repro_torch.core``)."""
    return {"odcl-kmeans++": lambda: pkg.ODCL(algorithm="kmeans++", k=10,
                                              **kw),
            "odcl-clusterpath": lambda: pkg.ODCL(
                algorithm="clusterpath",
                options=dict(n_lambdas=8, iters=200), **kw),
            "oracle-averaging": lambda: pkg.OracleAveraging(
                true_labels=fed.true_labels),
            "local-only": pkg.LocalOnly,
            "global-erm": pkg.GlobalERM}[name]()


@pytest.fixture(scope="module")
def quickstart_fed():
    from repro_torch.data import make_linear_regression_federation

    return make_linear_regression_federation(seed=0, n=200)


@pytest.mark.parametrize("name", QUICKSTART)
def test_quickstart_through_the_package_matches_reference(name,
                                                          quickstart_fed):
    import repro.core as jcore
    import repro_torch.core as tcore

    fed = quickstart_fed
    want = quickstart_method(jcore, name, fed).fit(
        jax.random.PRNGKey(0), fed.xs, fed.ys,
        lambda xs, ys: jcore.batched_ridge_erm(jnp.asarray(xs),
                                               jnp.asarray(ys), 1e-8))
    got = quickstart_method(tcore, name, fed, **(
        {"device": "cpu"} if name.startswith("odcl") else {})).fit(
        0, fed.xs, fed.ys,
        lambda xs, ys: tcore.batched_ridge_erm(torch.as_tensor(xs),
                                               torch.as_tensor(ys), 1e-8))
    assert got.n_clusters == want.n_clusters
    assert same_partition(got.labels, want.labels)
    if name.startswith("odcl"):
        assert same_partition(got.labels, fed.true_labels)
    assert int(got.comm_rounds) == int(want.comm_rounds)
    np.testing.assert_allclose(got.nmse(fed.optima, fed.true_labels),
                               want.nmse(fed.optima, fed.true_labels),
                               rtol=1e-4)


# ------------------------------------------------------------- prng

def test_key_fold_and_split_like():
    from repro_torch.utils import key_fold, prng, split_like

    key = prng.key(0)
    assert key_fold(key) == key
    assert key_fold(key, 3, 5) == prng.fold_in(prng.fold_in(key, 3), 5)
    assert key_fold(key, 3, 5) == key_fold(key, 3, 5) != key_fold(key, 5, 3)
    tree = {"w": torch.zeros(2), "layers": [torch.zeros(3), None,
                                             {"b": 1.0, "a": 2.0}]}
    keys = split_like(key, tree)
    assert split_like(key, tree) == keys
    assert keys["layers"][1] is None and set(keys) == {"w", "layers"}
    leaves = [keys["layers"][0], keys["layers"][2]["a"],
              keys["layers"][2]["b"], keys["w"]]    # tree_leaves order
    assert leaves == [prng.fold_in(key, i) for i in range(4)]
    assert len(set(leaves)) == 4 and key not in leaves
    assert all(isinstance(k, int) and 0 <= k < 1 << 32 for k in leaves)
    # the reference's shape contract: one key per leaf, the tree's structure
    jkeys = jax.tree_util.tree_leaves(jsplit_like(
        jax.random.PRNGKey(0), {"w": jnp.zeros(2), "layers": [
            jnp.zeros(3), {"b": 1.0, "a": 2.0}]}))
    assert len(jkeys) == len(leaves)


# -------------------------------------------------------------- protocols

def test_registered_plug_ins_are_instances_of_their_protocols():
    from repro_torch.core import (
        ClusteringAlgorithm,
        DeviceClusteringAlgorithm,
        get_algorithm,
        is_device_algorithm,
        list_algorithms,
    )
    from repro_torch.core.engine import (
        Aggregator,
        EdgeSet,
        get_aggregator,
        get_edge_set,
        list_aggregators,
        list_edge_sets,
    )
    import repro.core as jcore

    assert list_algorithms() == jcore.list_algorithms()
    for name in list_algorithms():
        algo = get_algorithm(name)
        assert isinstance(algo, ClusteringAlgorithm), name
        assert isinstance(algo, DeviceClusteringAlgorithm) == \
            is_device_algorithm(algo) == \
            jcore.is_device_algorithm(jcore.get_algorithm(name)), name
    assert all(isinstance(get_edge_set(n), EdgeSet) for n in list_edge_sets())
    assert all(isinstance(get_aggregator(n), Aggregator)
               for n in list_aggregators())


class DuckAlgorithm:
    """A plug-in with the protocol's members and no base class."""
    name = "duck-test"
    requires_k = True

    def __call__(self, generator, points, *, k=None, **options):
        from repro_torch.core import ClusteringResult

        labels = (np.arange(len(points)) % k).astype(np.int32)
        return ClusteringResult(labels=labels,
                                centers=np.zeros((k, points.shape[1])),
                                n_clusters=k, meta={})

    def admissibility_alpha(self, m, c_min):
        return 1.0


class DuckEdges:
    name = "duck-edges-test"

    def __call__(self, points, **options):
        from repro_torch.core.engine import CompleteEdges

        return CompleteEdges()(points)


class DuckAggregator:
    name = "duck-mean-test"
    breakdown = 0.0

    def __call__(self, flat, labels, onehot, counts, shard=None):
        return (onehot.T @ flat) / torch.clamp_min(counts, 1.0)[:, None]


def test_duck_typed_plug_ins_still_register():
    from repro_torch.core import (
        ClusteringAlgorithm,
        ODCL,
        get_algorithm,
        register_algorithm,
        unregister_algorithm,
    )
    from repro_torch.core.engine import (
        Aggregator,
        EdgeSet,
        cluster_reduce_tree,
        get_aggregator,
        get_edge_set,
        register_aggregator,
        register_edge_set,
        unregister_aggregator,
        unregister_edge_set,
    )

    algo, edges, agg = DuckAlgorithm(), DuckEdges(), DuckAggregator()
    assert isinstance(algo, ClusteringAlgorithm)
    assert isinstance(edges, EdgeSet) and isinstance(agg, Aggregator)
    register_algorithm(algo)
    register_edge_set(edges)
    register_aggregator(agg)
    try:
        assert get_algorithm(algo.name) is algo
        assert get_edge_set(edges.name) is edges
        assert get_aggregator(agg.name) is agg
        xs = np.random.default_rng(0).normal(size=(6, 4, 3)).astype(
            np.float32)
        ys = xs[..., 0]
        res = ODCL(algorithm=algo.name, k=2, aggregator=agg.name,
                   device="cpu").fit(0, xs, ys, lambda x, y: torch.as_tensor(
                       x[:, 0]))
        assert res.labels.tolist() == [0, 1, 0, 1, 0, 1]
        pts = torch.arange(12, dtype=torch.float32).reshape(4, 3)
        assert edges(pts).n_edges == 6
        onehot = torch.eye(2)[[0, 1, 0, 1]]
        reps = cluster_reduce_tree({"w": pts}, None, onehot, onehot.sum(0),
                                   agg.name)
        assert torch.equal(reps["w"], torch.stack([pts[::2].mean(0),
                                                   pts[1::2].mean(0)]))
    finally:
        unregister_algorithm(algo.name)
        unregister_edge_set(edges.name)
        unregister_aggregator(agg.name)
