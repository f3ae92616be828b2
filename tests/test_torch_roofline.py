"""The port's roofline (``repro_torch/roofline``) against the reference's
on the CPU, and the work counts the engine's programs record.

* ``active_param_count`` and ``model_flops`` equal the reference's as
  integers for every architecture and every input shape it supports, at
  full width, on a ``device="meta"`` tree of the reference's
  ``abstract_params`` shapes (no memory).
* ``roofline_terms`` and ``achieved_vs_peak`` give the reference's rows
  on the same costs and collectives (the reference parses them out of
  HLO text; the port takes the dict).
* The kernel count functions give the bounds of ``PERF.md``'s kernel
  table at the five main shapes within 0.1 %, flash's live pairs are
  the band mask's, and ``kernels/ops.py`` charges every engine kernel
  call to the calling thread's open tallies, whichever implementation
  runs.
* ``program_rows_from_snapshot`` on a synthetic snapshot, and on a CPU
  ``simulate``: the session's programs carry positive flops and bytes
  gauges, and the clustering program's count grows with the iterations
  that ran.
"""
import functools
import itertools
import threading

import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, INPUT_SHAPES
from repro.configs import get_config as jget_config
from repro.launch.inputs import shape_supported
from repro.models.transformer import abstract_params
from repro.roofline import analysis as janalysis
from repro.roofline import engine_costs as jengine_costs
from repro_torch import obs, runtime
from repro_torch.configs import get_config
from repro_torch.core.engine.aggregate import one_shot_aggregate_device
from repro_torch.interop import state_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch import simulate as tsimulate
from repro_torch.roofline import (
    HW_CPU,
    HW_H100,
    HW_H100_FP32,
    achieved_vs_peak,
    active_param_count,
    detect_hardware,
    engine_kernel_report,
    engine_costs,
    kernel_costs,
    model_flops,
    program_rows_from_snapshot,
    roofline_terms,
)

CASES = [(arch, shape) for arch, shape in itertools.product(
    ARCH_IDS, INPUT_SHAPES)
    if shape_supported(jget_config(arch), INPUT_SHAPES[shape])[0]]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One host thread: the tensors here are small, and parallel test
    workers must not oversubscribe the CPU."""
    with runtime.pinned_threads(1):
        yield


@functools.lru_cache(maxsize=None)
def reference_shapes(arch):
    return abstract_params(jget_config(arch))


def meta_tree(tree):
    """The reference's abstract tree as ``device="meta"`` tensors."""
    if isinstance(tree, dict):
        return {key: meta_tree(val) for key, val in tree.items()}
    return torch.empty(tree.shape, device="meta")


@pytest.mark.parametrize("arch,shape", CASES)
def test_param_counts_and_model_flops_match_the_reference(arch, shape):
    jcfg, cfg = jget_config(arch), get_config(arch)
    jtree = reference_shapes(arch)
    tree = meta_tree(jtree)
    want = janalysis.active_param_count(jtree, jcfg.n_experts, jcfg.top_k)
    got = active_param_count(tree, cfg.n_experts, cfg.top_k)
    assert got == tuple(int(v) for v in want)
    want_flops = janalysis.model_flops(jcfg, INPUT_SHAPES[shape], jtree)
    got_flops = model_flops(cfg, INPUT_SHAPES[shape], tree)
    assert int(got_flops) == int(want_flops) and got_flops > 0


def test_roofline_terms_match_the_reference():
    hlo = "\n".join([
        "%ag = f32[256,64]{1,0} all-gather(f32[16,64]{1,0} %p), dimensions={0}",
        "%ar = bf16[1024]{0} all-reduce(bf16[1024]{0} %g), to_apply=%add",
        "%cp = f32[8]{0} collective-permute(f32[8]{0} %x)"])
    collectives = janalysis.collective_bytes_from_hlo(hlo)
    arch, shape = "qwen2-0.5b", INPUT_SHAPES["train_4k"]
    jcfg, cfg = jget_config(arch), get_config(arch)
    jtree = reference_shapes(arch)
    cost = {"flops": 3.0e15, "bytes accessed": 2.0e12}
    for hw, jhw in ((HW_H100, janalysis.Hardware("h100", 989e12, 3.35e12,
                                                 450e9)),
                    (HW_CPU, janalysis.Hardware("cpu", 1e11, 2.5e10, 1e10))):
        want = janalysis.roofline_terms(
            arch=arch, shape=shape, mesh_name="16x16", chips=256, cost=cost,
            hlo_text=hlo, cfg=jcfg, params_shape=jtree, hw=jhw)
        got = roofline_terms(
            arch=arch, shape=shape, mesh_name="16x16", chips=256, cost=cost,
            collectives=collectives, cfg=cfg, params_shape=meta_tree(jtree),
            hw=hw)
        assert got.row() == pytest.approx(want.row())
        assert got.collective_detail == want.collective_detail


def test_h100_peaks():
    assert (HW_H100.peak_flops, HW_H100.hbm_bw, HW_H100.link_bw) == (
        989e12, 3.35e12, 450e9)
    assert (HW_H100_FP32.peak_flops, HW_H100_FP32.hbm_bw) == (67e12, 3.35e12)
    assert (HW_CPU.peak_flops, HW_CPU.hbm_bw, HW_CPU.link_bw) == (
        jengine_costs.HW_CPU.peak_flops, jengine_costs.HW_CPU.hbm_bw,
        jengine_costs.HW_CPU.link_bw)


def test_detect_hardware_names_the_card_or_raises(monkeypatch):
    assert detect_hardware("cpu") is HW_CPU
    monkeypatch.setattr(engine_costs, "resolve_device",
                        lambda device: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev: "NVIDIA H100 80GB HBM3")
    assert detect_hardware() is HW_H100_FP32
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(ValueError, match="A100"):
        detect_hardware()


def test_achieved_vs_peak_matches_the_reference():
    cost = {"flops": 1.5e9, "bytes accessed": 3.0e8}
    want = jengine_costs.achieved_vs_peak(cost, 2.5e-3,
                                          jengine_costs.HW_CPU)
    assert achieved_vs_peak(cost, 2.5e-3, HW_CPU) == pytest.approx(want)


# PERF.md's bound column (ms) at the five main shapes, and the cost
BOUNDS = [
    ("lloyd assign", 0.0814, HW_H100_FP32,
     kernel_costs.kmeans_assign(1_048_576, 8, 64)),
    ("kmeans++", 0.0901, HW_H100_FP32,
     kernel_costs.pairwise_sqdist(1_048_576, 8, 64)),
    ("batched prox", 0.6409, HW_H100_FP32,
     kernel_costs.group_ball_proj(8_386_560, 32, 1)),
    ("host prox", 0.0400, HW_H100_FP32,
     kernel_costs.group_ball_proj(523_776, 32, 1)),
    ("qwen2-0.5b flash", 0.3648, HW_H100,
     kernel_costs.flash_attention(4, 14, 2, 8192, 8192, 64, causal=True,
                                  window=4096, itemsize=2)),
]


@pytest.mark.parametrize("name,want_ms,hw,cost", BOUNDS,
                         ids=[b[0] for b in BOUNDS])
def test_count_functions_give_the_perf_table_bounds(name, want_ms, hw,
                                                    cost):
    nbytes, ops_ = cost
    got_ms = max(nbytes / hw.hbm_bw, ops_ / hw.peak_flops) * 1e3
    assert abs(got_ms - want_ms) <= 1e-3 * want_ms, got_ms


@pytest.mark.parametrize("sq,skv", [(1, 1), (7, 7), (64, 200), (300, 129),
                                    (129, 129)])
def test_flash_live_pairs_count_the_band(sq, skv):
    pos = torch.arange(sq)[:, None] + skv - sq
    key = torch.arange(skv)[None]
    for causal, window in itertools.product((True, False),
                                            (None, 1, 5, 64, 1000)):
        band = torch.ones((sq, skv), dtype=torch.bool)
        if causal:
            band &= key <= pos
        if window is not None:
            band &= key > pos - window
        assert kernel_costs.flash_live_pairs(sq, skv, causal, window) == \
            int(band.sum()), (causal, window)


def test_radius_elements_read():
    assert kernel_costs.radius_elems(0.75) == 1
    assert kernel_costs.radius_elems(torch.tensor(0.75)) == 1
    assert kernel_costs.radius_elems(torch.ones((3, 1))) == 3
    assert kernel_costs.radius_elems(torch.ones(()).expand(100)) == 1
    assert kernel_costs.radius_elems(torch.ones((2, 50))) == 100


def test_dispatch_charges_every_engine_kernel_call():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=(40, 6)).astype(np.float32))
    c = a[:3].clone()
    v = torch.from_numpy(rng.normal(size=(2, 9, 6)).astype(np.float32))
    with kernel_costs.tally() as outer:
        with kernel_costs.tally() as inner:
            ops.kmeans_assign(a, c)
            ops.pairwise_sqdist(a, c)
        ops.pairwise_sqdist(v, v)
        ops.group_ball_proj(v[0], 0.5)
        ops.group_ball_proj_batched(v, torch.ones((2, 1)))
    want_inner = [kernel_costs.kmeans_assign(40, 3, 6),
                  kernel_costs.pairwise_sqdist(40, 3, 6)]
    want = want_inner + [kernel_costs.pairwise_sqdist(9, 9, 6, 2),
                         kernel_costs.group_ball_proj(9, 6, 1),
                         kernel_costs.group_ball_proj(18, 6, 2)]
    assert (inner.bytes, inner.ops) == tuple(map(sum, zip(*want_inner)))
    assert (outer.bytes, outer.ops) == tuple(map(sum, zip(*want)))
    # another thread's calls never reach this thread's tally
    with kernel_costs.tally() as mine:
        t = threading.Thread(target=ops.kmeans_assign, args=(a, c))
        t.start()
        t.join(timeout=60)
    assert not t.is_alive() and (mine.bytes, mine.ops) == (0.0, 0.0)
    ops.kmeans_assign(a, c)          # no tally open: nothing to charge


def test_program_rows_from_a_synthetic_snapshot():
    snap = {"gauges": {"a.flops": 2.0e9, "a.bytes": 4.0e8,
                       "b.flops": 1.0, "other": 3.0},
            "histograms": {"a.execute.ms": {"count": 4, "p50": 20.0},
                           "b.execute.ms": {"count": 0}}}
    rows = program_rows_from_snapshot(snap, HW_CPU)
    assert list(rows) == ["a"]
    assert rows["a"]["exec_count"] == 4
    assert rows["a"] == pytest.approx(
        {**jengine_costs.program_rows_from_snapshot(
            snap, jengine_costs.HW_CPU)["a"]})
    assert rows["a"]["flops_frac_of_peak"] == pytest.approx(2.0e9 / 0.02
                                                            / 1e11)


PROGRAMS = ("session.finalize.cluster", "session.finalize.mean",
            "session.route.batch")


def run_programs(**kw):
    summary = tsimulate.simulate(clusters=8, route_probes=8,
                                 finalize_repeats=2, device="cpu", **kw)
    return summary, program_rows_from_snapshot(summary["obs"], HW_CPU)


def test_simulate_programs_carry_flops_and_bytes():
    summary, rows = run_programs(clients=4096)
    for label in PROGRAMS:
        assert rows[label]["flops"] > 0 and rows[label]["bytes"] > 0, label
        assert rows[label]["exec_count"] >= 2
    # the mean program: its stated one-hot term over (4096, 16) leaves
    assert rows["session.finalize.mean"]["flops"] == 4.0 * 4096 * 8 * 16


def test_fused_round_counts_its_sketch_and_mean():
    """``engine.round``: the kernels it called plus the JL sketch
    (2 C n s) and the one-hot mean (4 C K n)."""
    rng = np.random.default_rng(3)
    centers = 20.0 * rng.normal(size=(4, 12))
    theta = (centers[np.arange(64) % 4]
             + rng.normal(size=(64, 12))).astype(np.float32)
    obs.reset()
    with kernel_costs.tally() as spent:
        one_shot_aggregate_device(state_from_numpy({"theta": theta}, "cpu"),
                                  k=4, sketch_dim=8, device="cpu")
    gauges = obs.snapshot()["gauges"]
    own = 2.0 * 64 * 12 * 8 + 4.0 * 64 * 4 * 12
    assert spent.ops > 0
    assert gauges["engine.round.flops"] == spent.ops + own
    assert gauges["engine.round.bytes"] > spent.bytes


@pytest.mark.parametrize("algorithm,few,many,kw", [
    ("kmeans-device", {"kmeans_iters": 1}, {"kmeans_iters": 50},
     {"clients": 4096}),
    ("convex-device", {"cc_iters": 5}, {"cc_iters": 40},
     {"clients": 256, "sketch_dim": 32, "edges": "knn"})])
def test_cluster_program_counts_the_iterations_that_ran(algorithm, few,
                                                        many, kw):
    counts = []
    for iters in (few, many):
        summary, rows = run_programs(algorithm=algorithm, **kw, **iters)
        counts.append((summary["meta"]["n_iter"],
                       rows["session.finalize.cluster"]["flops"],
                       rows["session.finalize.cluster"]["bytes"]))
    (it_few, f_few, b_few), (it_many, f_many, b_many) = counts
    assert it_few < it_many
    assert f_few < f_many and b_few < b_many


def test_engine_kernel_report_on_the_cpu():
    (row,) = engine_kernel_report(512, 16, 8, "kmeans-device", device="cpu")
    assert row["name"] == "kmeans_assign" and row["shapes"] == [[512, 16],
                                                                [8, 16]]
    nbytes, ops_ = kernel_costs.kmeans_assign(512, 8, 16)
    assert (row["bytes"], row["flops"]) == (nbytes, ops_)
    assert row["exec_s"] > 0
    (row,) = engine_kernel_report(64, 8, 8, "convex-device", edges="knn",
                                  knn_k=4, device="cpu")
    assert (row["name"], row["edges"], row["edges_capped"]) == (
        "group_ball_proj_batched", 256, False)
    (row,) = engine_kernel_report(128, 8, 8, "convex-device",
                                  max_edges=1000, device="cpu")
    assert (row["edges"], row["edges_capped"]) == (1000, True)
    assert row["shapes"] == [[1, 1000, 8], [1, 1000]]
    assert row["bytes"] == kernel_costs.group_ball_proj(1000, 8, 1000)[0]
