"""The port's multi-device dry run (``repro_torch.launch.dryrun``) on a
fake CPU mesh, against the reference's where the two count the same.

* The CLI's ``main``, in a subprocess that owns its 256-rank fake
  process group, meets ``tests/test_dryrun_integration.py``'s
  assertions: xlstm_125m
  long_500k is OK on 256 ranks of a 16x16 mesh with a peak under 1 GiB
  and a named bottleneck; hubert_xlarge decode_32k is skipped as
  encoder-only.
* Every family's reduced config (one layer, d_model 64) traces OK under
  tp_fsdp for every step kind on a fake 4x4 mesh, with its flops, bytes
  and peak counted; one dense, one MoE and one recurrent family trace
  under every layout.
* ``odcl_local`` issues no collective over the ``data`` dim (the
  reference's "zero cross-client collectives"); ``tp_fsdp`` all-gathers
  over it (the FSDP weight gathers); every collective names its mesh
  dim.
* The argument bytes per rank equal the reference's
  ``argument_size_in_bytes`` for two reduced combos (the reference lowers
  in a subprocess with its 512 fake devices).  The port's decode cache
  holds its position as a host int; the reference's is a 4-byte int32
  array among its arguments.
* ``measure_combo``'s lerp from L = 2 and 4 equals the direct count at
  L = 5 (flops) and the deploy count (bytes, collectives) of a decode
  step: the port counts every op as it runs.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

from repro_torch import runtime
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import destroy_fake_process_group, make_debug_mesh
from repro_torch.roofline.measure import _cal_config, measure_combo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("qwen2_0_5b", "grok_1_314b", "deepseek_moe_16b", "xlstm_125m",
            "hymba_1_5b", "hubert_xlarge", "pixtral_12b")
SHAPES = {"train": InputShape("train", 8, 16, "train"),
          "prefill": InputShape("prefill", 8, 16, "prefill"),
          "decode": InputShape("decode_32k", 16, 16, "decode")}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One host thread: the tensors here are small, and parallel test
    workers must not oversubscribe the CPU."""
    with runtime.pinned_threads(1):
        yield


@pytest.fixture(scope="module")
def mesh():
    """A fake 4x4 CPU mesh; its process group goes with the module."""
    destroy_fake_process_group()
    yield make_debug_mesh(4, 4, device="cpu")
    destroy_fake_process_group()


def tiny(arch):
    return get_config(arch).reduced(
        n_layers=2 if arch == "xlstm_125m" else 1, max_d_model=64,
        max_vocab=128)


REFERENCE_ARG_BYTES = """
import json
import jax
import repro.launch.dryrun as d
from repro.configs import get_config
mesh = jax.make_mesh((4, 4), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
out = {}
for arch, shape in %r:
    cfg = get_config(arch).reduced(n_layers=1, max_d_model=64, max_vocab=128)
    _, info = d.lower_one(arch, shape, mesh=mesh, cfg_override=cfg)
    out[arch + " " + shape] = info["argument_bytes_per_device"]
print(json.dumps(out))
"""
ARG_COMBOS = (("qwen2_0_5b", "train_4k"), ("grok_1_314b", "decode_32k"))


@pytest.fixture(autouse=True, scope="module")
def background(tmp_path_factory):
    """The two runs in processes of their own, started with the module so
    that they overlap its traces: the CLI's ``main`` on the two combos
    (it owns its 256-rank fake process group; one JSON line each), and
    the reference's ``lower_one`` for the argument bytes."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = tmp_path_factory.mktemp("dryrun") / "d.jsonl"
    cli = ("import sys; from repro_torch.launch import dryrun; "
           "sys.exit(max(dryrun.main(a) for a in (%r, %r)))" % (
               ["--arch", "xlstm_125m", "--shape", "long_500k", "--json",
                str(out), "--device", "cpu"],
               ["--arch", "hubert_xlarge", "--shape", "decode_32k",
                "--json", str(out), "--device", "cpu"]))
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", code], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
        for name, code in (("cli", cli), ("reference", REFERENCE_ARG_BYTES
                                          % (ARG_COMBOS,)))}
    yield dict(procs, cli_out=out)
    for p in procs.values():
        p.kill()
        p.wait()


def _finish(proc) -> str:
    """Wait for a background run; its stdout, once it exited 0."""
    out, err = proc.communicate(timeout=480)
    assert proc.returncode == 0, out + err
    return out.strip()


_INFOS = {}
# One family a model kind traces under the three layouts besides tp_fsdp:
# dense attention, MoE and recurrent.  Every family traces under tp_fsdp.
LAYOUT_FAMILIES = ("qwen2_0_5b", "grok_1_314b", "xlstm_125m")


def _lower(mesh, arch, kind, layout):
    key = (arch, kind, layout)
    if key not in _INFOS:
        _INFOS[key] = dryrun.lower_one(
            arch, SHAPES[kind].name, mesh=mesh, cfg_override=tiny(arch),
            layout=layout, shape=SHAPES[kind])[1]
    return _INFOS[key]


@pytest.mark.parametrize("arch", FAMILIES)
def test_every_family_traces_under_every_layout_and_step(mesh, arch):
    """Every family traces each step kind under tp_fsdp; the families of
    ``LAYOUT_FAMILIES`` under every layout too.  The ODCL layouts refuse
    a serving step for every family."""
    cfg = tiny(arch)
    layouts = dryrun.LAYOUTS if arch in LAYOUT_FAMILIES else ("tp_fsdp",)
    for kind, shape in SHAPES.items():
        for layout in dryrun.LAYOUTS:
            if kind != "train" and layout.startswith("odcl") and (
                    kind != "decode" or cfg.causal):
                with pytest.raises(ValueError, match="training layout"):
                    dryrun.lower_one(arch, shape.name, mesh=mesh,
                                     cfg_override=cfg, layout=layout,
                                     shape=shape)
                continue
            if layout not in layouts:
                continue
            info = _lower(mesh, arch, kind, layout)
            if kind == "decode" and not cfg.causal:
                assert info["status"] == "SKIP"
                continue
            assert info["status"] == "OK", (kind, layout, info)
            assert info["chips"] == 16 and info["mesh"] == "4x4"
            assert info["step"] == kind
            assert info["flops_per_device"] > 0
            assert info["bytes_per_device"] > 0
            assert info["peak_bytes_per_device"] == (
                info["argument_bytes_per_device"]
                + info["temp_bytes_per_device"])
            assert info["roofline"]["bottleneck"] in (
                "compute", "memory", "collective")


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "grok_1_314b"])
def test_odcl_local_has_no_cross_client_collectives(mesh, arch):
    """Every collective resolves to a mesh dim by name (an unresolved
    process group would be recorded under its own name and fail here);
    the ODCL layouts' all span ``model`` alone."""
    def dims(layout):
        return _lower(mesh, arch, "train", layout)["collectives"][
            "_mesh_dims"]

    local = dims("odcl_local")
    assert local and all(set(by_dim) <= {"model"}
                         for by_dim in local.values()), local
    local_fsdp = dims("odcl_local_fsdp")
    assert all(set(by_dim) <= {"model"}
               for by_dim in local_fsdp.values()), local_fsdp
    tp_fsdp = dims("tp_fsdp")
    assert all(set(by_dim) <= {"data", "model"}
               for by_dim in tp_fsdp.values()), tp_fsdp
    assert tp_fsdp["all-gather"]["data"] > 0


def test_argument_bytes_equal_the_reference(mesh, background):
    infos = {}
    for arch, shape in ARG_COMBOS:
        cfg = get_config(arch).reduced(n_layers=1, max_d_model=64,
                                       max_vocab=128)
        infos[arch, shape] = dryrun.lower_one(arch, shape, mesh=mesh,
                                              cfg_override=cfg)[1]
    want = json.loads(_finish(background["reference"]).splitlines()[-1])
    for (arch, shape), info in infos.items():
        pos_bytes = 4 if shape.startswith("decode") else 0
        assert info["argument_bytes_per_device"] + pos_bytes == \
            want[f"{arch} {shape}"], (arch, shape, info, want)


def test_dryrun_single_combo_and_skip_rule(background):
    _finish(background["cli"])
    rec, skip = [json.loads(line) for line in
                 background["cli_out"].read_text().splitlines()]
    assert rec["status"] == "OK"
    assert rec["chips"] == 256
    assert rec["mesh"] == "16x16"
    assert rec["peak_bytes_per_device"] < 2 ** 30   # O(1) recurrent state
    assert "roofline" in rec and rec["roofline"]["bottleneck"] in (
        "compute", "memory", "collective")
    assert skip["status"] == "SKIP"
    assert "encoder-only" in skip["reason"]


def test_measure_combo_lerp_equals_the_direct_count(mesh):
    arch = "hymba_1_5b"        # attention and the SSM state a layer
    cfg = dataclasses.replace(tiny(arch), n_layers=5)
    shape = SHAPES["decode"]
    report, info = measure_combo(arch, shape.name, mesh, cfg_override=cfg,
                                 shape=shape)
    assert info["status"] == "OK" and set(info["cal"]) == {"2", "4"}
    direct, _ = dryrun.lower_one(arch, shape.name, mesh=mesh, shape=shape,
                                 cfg_override=_cal_config(cfg, 5,
                                                          direct=True))
    deploy, _ = dryrun.lower_one(arch, shape.name, mesh=mesh, shape=shape,
                                 cfg_override=cfg)
    coll = sum(v for k, v in deploy.collective_bytes().items()
               if not k.startswith("_"))
    assert report.flops_per_device == direct.flops
    assert report.bytes_per_device_hbm == deploy.bytes
    assert report.coll_bytes_per_device == coll
    assert report.bottleneck in ("compute", "memory", "collective")
