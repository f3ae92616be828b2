"""The plain reference against the program's round on the CPU at a small
C: the same sketch rows, partition (up to the clusters' names), cluster
models and centers; and an output the test perturbs fails the judge."""
import json

import numpy as np
import pytest
import torch

from odcl_bench import harness, inputs, judge
from odcl_bench.reference import convex, kmeans, sketch


def _round(root, workload, seed=3):
    bench = harness.load_bench(root)
    _, cfg, mix = harness.resolve(bench, workload, root)
    session_cls, _, _ = harness.import_program(root)
    loop = harness.Loop(session_cls, cfg, mix, seed, "cpu")
    harness.set_up(loop)
    while loop.g < 3 or loop.last[0] != loop.g:
        loop.round(loop.g + 1)
    out = loop.outputs()
    # each client's latest upload, in the session's row order
    want, live = loop.up.live(out["last"])
    live = live[torch.as_tensor(np.searchsorted(want, out["ids"]))]
    return cfg, loop, out, live


def _same_partition(a, b):
    a, b = torch.as_tensor(a).long(), torch.as_tensor(b).long()
    pairs = torch.unique(a * (int(b.max()) + 1) + b).numel()
    return pairs == torch.unique(a).numel() == torch.unique(b).numel()


@pytest.mark.parametrize("workload", ["km-1m-round", "km-1m-refresh",
                                      "cc-4k-round"])
def test_reference_agrees_with_the_programs_round(tiny_root, workload):
    cfg, loop, out, live = _round(tiny_root, workload)
    a = sketch(live, loop.up.projection)
    assert judge.rel_err(out["sketches"], a) < 1e-6
    if cfg["reference"] == "kmeans":
        ref = kmeans.cluster(a, cfg["clusters"], iters=50,
                             tol=cfg["lloyd_tol"],
                             generator=inputs.generator(3, 7, "cpu"))
    else:
        ref = convex.cluster(a, loop.lam, iters=cfg["algo_options"]["iters"],
                             tol=cfg["ama_tol"])
    labels = out["labels"]
    assert _same_partition(labels, ref["labels"])
    # name the reference's clusters by the program's
    order = [int(ref["labels"][int((labels == c).nonzero()[0])])
             for c in range(int(labels.max()) + 1)]
    assert judge.rel_err(out["centers"], ref["centers"][order]) < 1e-5
    means, _ = judge.cluster_means(live, labels, len(order))
    assert judge.rel_err(out["models"], means) < 1e-6
    values, _ = judge.compare(cfg, out, loop.up, loop.lam)
    assert judge.checks(values, cfg["limits"])[0], values


def _flip_label(out):
    labels = out["labels"].clone()
    labels[0] = (labels[0] + 1) % (int(labels.max()) + 1)
    return dict(out, labels=labels)


def _bump_sketch(out):
    sk = out["sketches"].clone()
    sk[1] *= 1.001
    return dict(out, sketches=sk)


def _bump_center(out):
    c = out["centers"].clone()
    c[0] *= 1.001
    return dict(out, centers=c)


def _bump_model(out):
    m = out["client_models"].clone()
    m[2] *= 1.001
    return dict(out, client_models=m)


@pytest.mark.parametrize("workload", ["km-1m-round", "cc-4k-round"])
@pytest.mark.parametrize("perturb,number", [
    (_flip_label, None), (_bump_sketch, "sketch_err"),
    (_bump_center, "center_err"), (_bump_model, "model_err")])
def test_a_perturbed_output_fails(tiny_root, workload, perturb, number):
    cfg, loop, out, live = _round(tiny_root, workload)
    values, _ = judge.compare(cfg, perturb(out), loop.up, loop.lam)
    ok, checks = judge.checks(values, cfg["limits"])
    assert not ok, json.dumps(checks)
    if number is None:
        number = ("label_miss" if cfg["reference"] == "kmeans"
                  else "partition_miss")
    assert checks[number]["value"] > checks[number]["limit"]


def _drop_client(out):
    return dict(out, ids=out["ids"][1:])


def _stale(out):
    return dict(out, round=out["round"] - 1)


@pytest.mark.parametrize("perturb,number", [(_drop_client, "live_miss"),
                                            (_stale, "stale_rounds")])
def test_a_wrong_live_set_or_a_stale_round_fails(tiny_root, perturb, number):
    cfg, loop, out, _ = _round(tiny_root, "km-1m-refresh")
    values, _ = judge.compare(cfg, perturb(out), loop.up, loop.lam)
    ok, checks = judge.checks(values, cfg["limits"])
    assert not ok and checks[number]["value"] > 0
    assert checks["sketch_err"]["value"] == float("inf")


def test_the_seeding_is_held_to_the_references_best(tiny_root):
    cfg, loop, out, _ = _round(tiny_root, "km-1m-round")
    g = out["round"]
    gen = inputs.generator(3, 8, "cpu")
    good = judge.seeding(cfg, loop.up, {g: out["centers"]}, gen)
    # two clusters' centers on one point: a merge Lloyd does not undo
    bad = out["centers"].clone()
    bad[1] = bad[0]
    worse = judge.seeding(cfg, loop.up, {g: bad}, gen)
    assert good == {"seeding_miss_share": 0.0}
    assert worse == {"seeding_miss_share": 1.0}


def test_a_tie_is_no_miss_and_a_wrong_center_is():
    centers = torch.tensor([[0.0, 0.0], [2.0, 0.0]], dtype=torch.float64)
    a = torch.tensor([[1.0, 0.0], [1.0 + 1e-9, 3.0], [0.1, 0.0]],
                     dtype=torch.float64)
    cfg = {"clusters": 2}
    tied, _ = kmeans.judge(a, torch.tensor([0, 0, 0]), centers, cfg)
    assert tied["label_miss"] == 0
    wrong, _ = kmeans.judge(a, torch.tensor([1, 1, 1]), centers, cfg)
    assert wrong["label_miss"] == 1


def test_the_judge_refuses_a_number_without_a_limit():
    ok, checks = judge.checks({"x": 0.0}, {})
    assert not ok and checks["x"]["limit"] is None
