"""The port's sharding rules (``repro_torch.sharding``) and dry-run inputs
(``repro_torch.launch.inputs``) against the reference's.

* ``param_specs`` gives the reference's ``PartitionSpec`` entries exactly
  (a spec is a tuple of the same entries) for all ten architectures at
  full width (meta tensors, nothing allocated), on the 16x16 and 2x16x16
  meshes, under ``make_rules``' train and serve rules and the
  ``pure_fsdp``, ``odcl_local`` and ``odcl_local_fsdp`` rules;
* ``cache_specs`` gives the reference's entries with its leading layer
  axis dropped (the port's cache is a list of per-layer dicts), also
  under ``splitk_decode``; ``batch_spec`` the reference's;
* ``abstract_params`` and ``input_specs`` give the reference's shapes and
  dtypes for every supported (arch, shape); ``shape_supported`` the same
  decisions and reasons; ``serve_config`` the same config;
* ``placements`` puts a tuple entry on every mesh dim it names;
* outside ``activation_sharding`` every constraint returns its input.

The reference's ``make_rules`` is read from ``repro.launch.dryrun``,
which sets ``XLA_FLAGS`` when imported: the import restores it.
"""
import dataclasses
import importlib
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro.launch import inputs as jinp
from repro.models import transformer as jtr
from repro.sharding import ShardingRules as JRules
from repro.sharding import batch_spec as jbatch_spec
from repro.sharding import cache_specs as jcache_specs
from repro.sharding import param_specs as jparam_specs
from repro_torch import runtime
from repro_torch.configs import get_config as tget_config
from repro_torch.launch import dryrun as tdryrun
from repro_torch.launch import inputs as tinp
from repro_torch.models import transformer as ttr
from repro_torch.sharding import (
    ShardingRules,
    batch_spec,
    cache_specs,
    opt_state_specs,
    param_specs,
    placements,
)
from repro_torch.sharding import activations as tact
from repro_torch.utils import tree_map


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One host thread: the tensors here are small, and parallel test
    workers must not oversubscribe the CPU."""
    with runtime.pinned_threads(1):
        yield


class JMesh:
    """Just enough of a jax Mesh for the reference's spec builders."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.zeros(shape)


class TMesh:
    """Just enough of a DeviceMesh for the port's spec builders."""

    def __init__(self, shape, names):
        self.mesh_dim_names = names
        self.shape = shape


MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
LAYOUTS = ("train", "serve", "pure_fsdp", "odcl_local", "odcl_local_fsdp")


def _meshes(name):
    shape, names = MESHES[name]
    return JMesh(shape, names), TMesh(shape, names)


@pytest.fixture(scope="module")
def jdryrun():
    """The reference's dryrun module, imported without leaving its
    XLA_FLAGS behind."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


_ABSTRACT = {}


def _abstract(arch):
    if arch not in _ABSTRACT:
        _ABSTRACT[arch] = (jtr.abstract_params(get_config(arch)),
                           ttr.abstract_params(tget_config(arch)))
    return _ABSTRACT[arch]


def _flat(tree, prefix=""):
    """{path: leaf} of nested dicts (specs are tuple leaves)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def _jflat(tree, is_leaf=None):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=is_leaf)[0]:
        out["/".join(str(getattr(p, "key", getattr(p, "name", p)))
                     for p in path)] = leaf
    return out


def _rules(layout, jmesh, tmesh, jdr, arch):
    names = tmesh.mesh_dim_names
    if layout in ("train", "serve"):
        kind = "train" if layout == "train" else "decode"
        return (jdr.make_rules(get_config(arch), jmesh, kind),
                tdryrun.make_rules(tget_config(arch), tmesh, kind))
    if layout == "pure_fsdp":
        args = dict(data_axes=tuple(names), model_axis=None, fsdp=True)
    elif layout == "odcl_local":
        args = dict(data_axes=(), model_axis="model", fsdp=False,
                    client_axis="data")
    else:
        args = dict(data_axes=("model",), model_axis=None, fsdp=True,
                    client_axis="data")
    return JRules(**args), ShardingRules(**args)


def _stack(jparams, tparams, n):
    """Both trees with a leading client axis of n."""
    return (jax.tree_util.tree_map(
                lambda l: jax.ShapeDtypeStruct((n,) + l.shape, l.dtype),
                jparams),
            tree_map(lambda l: tinp.sds((n,) + tuple(l.shape), l.dtype),
                     tparams))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_reference(arch, layout, mesh_name, jdryrun):
    jmesh, tmesh = _meshes(mesh_name)
    jrules, trules = _rules(layout, jmesh, tmesh, jdryrun, arch)
    assert dataclasses.asdict(jrules) == dataclasses.asdict(trules)
    jparams, tparams = _abstract(arch)
    if trules.client_axis is not None:
        jparams, tparams = _stack(jparams, tparams, 16)
    want = _jflat(jparam_specs(get_config(arch), jparams, jrules, jmesh),
                  is_leaf=lambda x: isinstance(x, P))
    got = _flat(param_specs(tget_config(arch), tparams, trules, tmesh))
    assert set(got) == set(want)
    for path, spec in want.items():
        assert got[path] == tuple(spec), (path, got[path], spec)
    assert opt_state_specs(got)["step"] == ()


def _cache_cases():
    return [(a, s) for a in ARCH_IDS for s in ("decode_32k", "long_500k")
            if jinp.shape_supported(get_config(a), INPUT_SHAPES[s])[0]]


@pytest.mark.parametrize("splitk", [False, True])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,shape", _cache_cases())
def test_cache_specs_equal_the_reference_without_the_layer_axis(
        arch, shape, mesh_name, splitk, jdryrun):
    jmesh, tmesh = _meshes(mesh_name)
    jcfg = dataclasses.replace(get_config(arch), splitk_decode=splitk)
    tcfg = dataclasses.replace(tget_config(arch), splitk_decode=splitk)
    jrules = jdryrun.make_rules(jcfg, jmesh, "decode")
    trules = tdryrun.make_rules(tcfg, tmesh, "decode")
    jcache, _ = jinp.decode_input_specs(jcfg, INPUT_SHAPES[shape])
    tcache, _ = tinp.decode_input_specs(tcfg, INPUT_SHAPES[shape])
    want = _jflat(jcache_specs(jcfg, jcache, jrules, jmesh),
                  is_leaf=lambda x: isinstance(x, P))
    got = cache_specs(tcfg, tcache, trules, tmesh)
    assert got.pos == () and tuple(want.pop("pos")) == ()
    assert len(got.layers) == jcache.layers[
        next(iter(jcache.layers))].shape[0]
    for lay in got.layers:
        assert {f"layers/{k}": v for k, v in lay.items()} == {
            k: tuple(v)[1:] for k, v in want.items()}
    for lay in got.layers:
        if "k" in lay and not splitk:
            assert len(lay["k"]) < 3 or lay["k"][2] is None


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_spec_equals_the_reference(mesh_name):
    jmesh, tmesh = _meshes(mesh_name)
    data = ("pod", "data") if mesh_name == "2x16x16" else ("data",)
    for jr, tr_ in ((JRules(data_axes=data), ShardingRules(data_axes=data)),
                    (JRules(data_axes=(), client_axis="data"),
                     ShardingRules(data_axes=(), client_axis="data"))):
        jfn = jbatch_spec(get_config("qwen2_0_5b"), jr, jmesh)
        tfn = batch_spec(tget_config("qwen2_0_5b"), tr_, tmesh)
        for shape in ((256, 128), (1, 1), (16, 16, 4), (512, 8), (4,)):
            want = jfn(jax.ShapeDtypeStruct(shape, np.int32))
            got = tfn(torch.empty(shape, dtype=torch.int32, device="meta"))
            assert got == tuple(want), (shape, got, want)
        assert tfn(3) == tuple(jfn(3))


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _same_leaves(jtree, ttree):
    want = {k: (tuple(v.shape), _dtype(v)) for k, v in _jflat(jtree).items()}
    got = {k: (tuple(v.shape), _dtype(v)) for k, v in _flat(ttree).items()}
    assert got == want


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_equal_the_reference(arch):
    jparams, tparams = _abstract(arch)
    _same_leaves(jparams, tparams)
    assert all(t.device.type == "meta" for t in _flat(tparams).values())


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_and_skip_rules_equal_the_reference(arch, shape):
    jcfg, tcfg = get_config(arch), tget_config(arch)
    ishape = INPUT_SHAPES[shape]
    assert tinp.shape_supported(tcfg, ishape) == jinp.shape_supported(
        jcfg, ishape)
    assert dataclasses.asdict(tinp.serve_config(tcfg, ishape)) == \
        dataclasses.asdict(jinp.serve_config(jcfg, ishape))
    if not jinp.shape_supported(jcfg, ishape)[0]:
        return
    if ishape.kind == "decode":
        jcache, jtok = jinp.decode_input_specs(jcfg, ishape)
        tcache, ttok = tinp.decode_input_specs(tcfg, ishape)
        assert (tuple(ttok.shape), _dtype(ttok)) == (jtok.shape, _dtype(jtok))
        jl = _jflat(jcache.layers)
        for lay in tcache.layers:
            assert {f"{k}": (tuple(v.shape), _dtype(v))
                    for k, v in lay.items()} == {
                k: (v.shape[1:], _dtype(v)) for k, v in jl.items()}
        assert tcache.pos == 0
        return
    jspecs = jinp.input_specs(jcfg, ishape)
    tspecs = tinp.input_specs(tcfg, ishape)
    assert set(tspecs) == set(jspecs)
    for key in jspecs:
        _same_leaves(jspecs[key], tspecs[key])
    assert tinp.N_PATCHES == jinp.N_PATCHES


def test_placements_put_a_tuple_entry_on_each_named_dim():
    from torch.distributed.tensor import Replicate, Shard

    mesh = TMesh((2, 16, 16), ("pod", "data", "model"))
    assert placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert placements((None, "data"), mesh) == (
        Replicate(), Shard(1), Replicate())
    assert placements((), mesh) == (Replicate(),) * 3


def test_constraints_are_identities_outside_the_context():
    x = torch.randn(4, 6, 8)
    assert tact.current_ctx() is None
    assert tact.constrain(x, "batch", None, "model") is x
    assert tact.constrain_params(x) is x
    assert tact.model_divides(7)
    idx = torch.randint(0, 8, (4, 6))
    assert torch.equal(tact.gather_last(x, idx), torch.take_along_dim(
        x, idx[..., None], dim=-1)[..., 0])
    assert torch.equal(tact.per_shard(torch.sigmoid, x), torch.sigmoid(x))
    assert torch.equal(tact.batch_local(lambda a: a * 2, x), x * 2)
    assert torch.equal(tact.heads_local(lambda a, b: a + b, x, x), x + x)
