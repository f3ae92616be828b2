"""A rehearsal of the harness on the CPU: every cell, mix and metric of
``BENCHMARK.json`` resolved by name and each mix's loop driven for a
few rounds at a tiny C; a configuration, a mix and a metric added by
new files alone; the command's refusals.  No device metric comes out
of a run off the card."""
import json
import subprocess
import sys

import pytest
import torch

from odcl_bench import harness, inputs

from conftest import REPO

BENCH = harness.load_bench(REPO)
CELLS = [c["name"] for c in BENCH["workloads"]]
# a mix of one-shot rounds, which new ones start from
MIX = {"reupload_share": 1.0, "churn": 0, "max_age": None, "drift_scale": 0.0,
       "mutation_rounds": 1, "pool": 2, "probes": 0, "round": "finalize"}
# metrics only a card's run gives
DEVICE = {"round_mfu", "device_idle", "kmeans_assign_roofline",
          "pairwise_sqdist_roofline", "group_ball_proj_roofline",
          "round_mfu.km", "device_idle.km", "pairwise_sqdist_roofline.km",
          "memory_peak_gb"}


def test_every_name_resolves_to_its_file():
    for cell in CELLS:
        harness.resolve(BENCH, cell, REPO)
    for group in ("end_to_end", "per_layer"):
        for m in BENCH[group]:
            assert callable(harness.reader(m["name"], REPO).read)
    for c in BENCH["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        harness.import_program(REPO)
        __import__(f"odcl_bench.reference.{cfg['reference']}")


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_runs_a_few_rounds_on_the_cpu(tiny_root, cell, traced):
    result = harness.run(cell, 2 ** 31 + 5, 0.3, traced, device="cpu",
                         root=tiny_root)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    wanted = {m["name"] for m in harness.metric_entries(BENCH, cell, traced)}
    assert set(result["metrics"]) == wanted - DEVICE
    assert list(result)[-1] == "checks"
    assert "busy_s" not in result["device"] and "breakdown" not in result


def test_new_files_alone_add_a_config_a_mix_and_a_metric(tiny_root):
    before = {p: p.read_bytes() for p in (tiny_root / "odcl_bench").rglob("*")
              if p.is_file()}
    cfg = json.loads((tiny_root / "odcl_bench/configs/odcl-km-1m.json")
                     .read_text())
    cfg.update(name="throwaway", clients=256)
    (tiny_root / "odcl_bench/configs/throwaway.json").write_text(
        json.dumps(cfg))
    (tiny_root / "odcl_bench/traffic/half-wave.json").write_text(
        json.dumps(dict(MIX, reupload_share=0.5, pool=3)))
    (tiny_root / "odcl_bench/metrics/rounds_run.py").write_text(
        "def read(ctx):\n    return float(len(ctx['rounds']))\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "throwaway", "source": "a test",
                             "file": "odcl_bench/configs/throwaway.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "throwaway.half", "config": "throwaway",
                               "traffic": "half-wave", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "rounds_run", "unit": "rounds",
                               "better": "higher", "source": "host_clock",
                               "layer": "round", "moves": "memory_peak_gb",
                               "workloads": ["throwaway.half"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    for path, data in before.items():
        assert path.read_bytes() == data
    result = harness.run("throwaway.half", 9, 0.2, True, device="cpu",
                         root=tiny_root)
    assert result["correct"] is True
    assert result["metrics"]["rounds_run"]["value"] == result["attempted"]


def test_the_same_seed_gives_the_same_inputs():
    cfg = {"clients": 64, "clusters": 8, "dim": 16, "samples": 8,
           "noise": 1.0, "reg": 1e-6, "sketch_dim": 4, "optima_seed": 0}
    mix = dict(MIX, reupload_share=0.25, churn=8, max_age=3, drift_scale=2.0,
               mutation_rounds=3, pool=3, probes=16)
    a, b = (inputs.Uploads(cfg, mix, 2 ** 33 + 1, "cpu") for _ in range(2))
    c = inputs.Uploads(cfg, mix, 2 ** 33 + 2, "cpu")
    for name in ("pool", "joiners"):
        assert all(torch.equal(x, y) for e, f in zip(getattr(a, name),
                                                     getattr(b, name))
                   for x, y in zip(e, f))
    assert all(torch.equal(x, y) for x, y in zip(a.probes, b.probes))
    assert torch.equal(a.projection, b.projection)
    assert not torch.equal(a.pool[0][0], c.pool[0][0])
    assert torch.equal(a.optima, c.optima)      # the deployment's


def test_the_schedule_keeps_the_last_three_waves_live():
    cfg = {"clients": 64, "clusters": 8, "dim": 4, "samples": 8,
           "noise": 1.0, "reg": 1e-6, "sketch_dim": 4, "optima_seed": 0}
    mix = dict(MIX, reupload_share=0.25, churn=8, max_age=3, drift_scale=2.0,
               mutation_rounds=3, pool=3)
    up = inputs.Uploads(cfg, mix, 5, "cpu")
    ids, models = up.live(-1)
    assert ids.tolist() == list(range(64)) and torch.equal(
        models, torch.cat(up.init))
    # round 4 ran steps 12-14: blocks 1 and 2 (steps 13, 14) and their
    # joiners are within 3 waves of the clock, the rest is gone
    ids, models = up.live(4)
    assert ids.tolist() == (list(range(16, 48)) + list(range(64 + 8 * 13,
                                                             64 + 8 * 15)))
    e = up.pool[4 % 3]
    assert torch.equal(models, torch.cat([e[1], e[2], up.joiners[1][1],
                                          up.joiners[1][2]]))


def test_the_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, "odcl_bench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


def test_the_harness_refuses_a_checkout_without_the_program(tmp_path):
    (tmp_path / "odcl_bench").mkdir()
    with pytest.raises(RuntimeError, match="not in this checkout"):
        harness.import_program(tmp_path)
