"""The port's checkpoints against the reference's file format, both ways.

A stacked federation of the tiny config (fp32 and bf16) written by one
package is read by the other bit for bit: the reference writes zstd
where ``zstandard`` imports (and zlib without it), the port writes zlib
and reads both.  The port's own msgpack subset packs the same bytes as
``msgpack.packb(..., use_bin_type=True)``.
"""
import os
import zlib

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.core.federated import init_federation as jinit_federation
from repro_torch import runtime
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.checkpoint.msgpack_lite import packb, unpackb
from repro_torch.interop import module_state_dict, params_from_numpy
from repro_torch.launch.steps import client_slice
from repro_torch.models.transformer import (
    init_params,
    init_tree,
    model_view,
    tree_from_model,
)
from repro_torch.utils import tree_leaves, tree_leaves_with_path, tree_map

from test_torch_train_step import tiny_cfgs


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One host thread: the tensors here are small, and parallel test
    workers must not oversubscribe the CPU."""
    with runtime.pinned_threads(1):
        yield


def ref_stack(dtype=jnp.float32, c=3):
    jcfg = tiny_cfgs()[0]
    state = jinit_federation(jax.random.PRNGKey(0), jcfg, c, same_init=False)
    return jax.tree_util.tree_map(lambda l: l.astype(dtype), state.params)


def assert_bit_equal(port_tree, ref_tree):
    for (path, t), r in zip(tree_leaves_with_path(port_tree),
                            jax.tree_util.tree_leaves(ref_tree)):
        r = np.asarray(r)
        assert str(t.dtype).split(".")[-1] == r.dtype.name, path
        assert tuple(t.shape) == r.shape, path
        got = t.contiguous().view(torch.uint8).numpy().tobytes()
        assert got == r.tobytes(), path


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["fp32", "bf16"])
def test_port_reads_reference_checkpoints(tmp_path, monkeypatch, dtype):
    ref = ref_stack(dtype)
    jckpt.save_checkpoint(str(tmp_path / "zstd"), 7, ref)
    monkeypatch.setattr(jckpt, "zstandard", None)
    jckpt.save_checkpoint(str(tmp_path / "zlib"), 7, ref)
    for sub in ("zstd", "zlib"):
        assert latest_step(str(tmp_path / sub)) == 7
        got = restore_checkpoint(str(tmp_path / sub), 7, ref)
        assert_bit_equal(got, ref)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["fp32", "bf16"])
def test_reference_reads_port_checkpoints(tmp_path, dtype):
    ref = ref_stack(dtype)
    port = params_from_numpy(jax.tree_util.tree_map(np.asarray, ref), "cpu")
    path = save_checkpoint(str(tmp_path), 3, port)
    assert os.path.basename(path) == "step_3.ckpt"
    with open(path, "rb") as f:
        blob = f.read()
    assert blob[:4] != b"\x28\xb5\x2f\xfd"          # zlib, never zstd
    back = jckpt.restore_checkpoint(str(tmp_path), 3, ref)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(ref)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    # the same map, packed to the same bytes
    assert zlib.decompress(blob) == msgpack.packb(jckpt._flatten(ref),
                                                  use_bin_type=True)
    assert_bit_equal(restore_checkpoint(str(tmp_path), 3, port), ref)


def test_round_trip_and_single_model_template(tmp_path):
    _, tcfg = tiny_cfgs()
    tree = init_tree(tcfg, seed=1, device="cpu")
    stacked = tree_map(lambda l: torch.stack([l, l + 1]), tree)
    save_checkpoint(str(tmp_path), 0, stacked)
    save_checkpoint(str(tmp_path), 12, stacked)
    assert latest_step(str(tmp_path)) == 12
    assert latest_step(str(tmp_path / "none")) is None
    back = restore_checkpoint(str(tmp_path), 12, tree)   # single template
    for a, b in zip(tree_leaves(back), tree_leaves(stacked)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # a restored client serves as the model it was
    model = init_params(tcfg, seed=1, device="cpu")
    want = module_state_dict(tree)
    assert set(want) == set(model.state_dict())
    for name, t in model.state_dict().items():
        assert torch.equal(want[name], t), name
    view = model_view(client_slice(back, 0), tcfg)
    assert torch.equal(view.layers[0].attn.wq, model.layers[0].attn.wq)
    assert torch.equal(tree_from_model(model)["embed"], tree["embed"])


def test_zstd_without_the_module_raises_like_the_reference(tmp_path,
                                                           monkeypatch):
    ref = ref_stack(c=1)
    jckpt.save_checkpoint(str(tmp_path), 1, ref)
    monkeypatch.setattr(tckpt, "zstandard", None)
    with pytest.raises(RuntimeError, match="zstandard"):
        restore_checkpoint(str(tmp_path), 1, ref)


@pytest.mark.parametrize("value", [
    {"a": {"dtype": "float32", "shape": [2, 3], "data": b"x" * 300}},
    {f"k{i}": i for i in range(40)},
    [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32, -33, -200,
     -40_000, -2 ** 40, None, True, False, 1.5, "s" * 40, "t" * 300,
     b"b" * 70_000, [1] * 20, []],
    {"shape": [], "data": b""}])
def test_msgpack_subset_matches_msgpack(value):
    packed = msgpack.packb(value, use_bin_type=True)
    assert packb(value) == packed
    assert unpackb(packed) == msgpack.unpackb(packed, raw=False)
    with pytest.raises(ValueError):
        unpackb(packed + b"\x00")
