"""The port's drivers on the CPU: ``launch.train`` -> checkpoint ->
``launch.serve`` (a client's slice, the routed cluster model, the route
server), and ``launch.simulate --method ifca|fedavg`` against the
reference's simulate.

The train -> serve round trip runs the drivers' ``--reduced`` qwen2-0.5b
(2 layers, d 512, vocab 256) at a small batch and sketch; the reference's
serve driver reads the port's checkpoint.  The simulate comparison runs
the same federation size in both packages (each draws its own clients):
both recover the planted partition and report the same comm rounds and
bytes.
"""
import json

import pytest
import torch

from repro.launch import serve as jserve
from repro.launch import simulate as jsimulate
from repro_torch import runtime
from repro_torch.checkpoint import latest_step, restore_checkpoint
from repro_torch.core.engine.aggregators import cluster_aggregate_tree
from repro_torch.launch import serve as tserve
from repro_torch.launch import simulate as tsimulate
from repro_torch.launch import train as ttrain
from repro_torch.utils import tree_leaves

TRAIN = ["--reduced", "--clients", "4", "--clusters", "2", "--batch", "1",
         "--seq-len", "8", "--sketch-dim", "16", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One host thread: the tensors here are small, and parallel test
    workers must not oversubscribe the CPU."""
    with runtime.pinned_threads(1):
        yield


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """One ODCL run of the train driver (device engine), checkpointed."""
    path = tmp_path_factory.mktemp("ckpt")
    trace = path / "train.jsonl"
    state, labels = ttrain.main(TRAIN + [
        "--local-steps", "2", "--post-steps", "1", "--engine", "device",
        "--ckpt-dir", str(path), "--trace", str(trace)])
    return path, state, labels, trace


def test_train_writes_a_stacked_checkpoint_and_trace(ckpt):
    path, state, labels, trace = ckpt
    assert latest_step(str(path)) == state.step == 3
    assert sorted(set(labels.tolist())) == [0, 1]
    events = [json.loads(line) for line in trace.read_text().splitlines()]
    (round_event,) = [e for e in events if e.get("event") == "fed.round"]
    assert round_event["method"] == "odcl" and round_event["clients"] == 4
    back = restore_checkpoint(str(path), 3, state.params)
    for a, b in zip(tree_leaves(back), tree_leaves(state.params)):
        assert torch.equal(a, b)


def test_serve_a_client_slice_in_both_packages(ckpt, capsys):
    path = str(ckpt[0])
    args = ["--reduced", "--batch", "1", "--prompt-len", "4", "--gen", "3",
            "--ckpt-dir", path, "--client", "1"]
    tokens = tserve.main(args + ["--device", "cpu"])
    assert tokens.shape == (1, 7)
    assert "[ckpt] restored step 3 (client 1)" in capsys.readouterr().out
    # the reference's driver reads the port's checkpoint
    jserve.main(args)
    assert "[ckpt] restored step 3 (client 1)" in capsys.readouterr().out


def test_serve_routes_by_sketch_to_the_cluster_mean(ckpt, capsys):
    path, state, labels, _ = ckpt
    tserve.main(["--reduced", "--batch", "1", "--prompt-len", "4", "--gen",
                 "2", "--ckpt-dir", str(path), "--client", "1",
                 "--route-by-sketch", "--clusters", "2",
                 "--route-sketch-dim", "16", "--device", "cpu"])
    assert "client 1 routed to cluster" in capsys.readouterr().out
    stacked = restore_checkpoint(str(path), 3, state.params)
    model, cid, info = tserve.route_from_checkpoint(
        stacked, None, 1, algorithm="kmeans-device", clusters=2,
        sketch_dim=16, device="cpu")
    lab = torch.as_tensor(info["labels"])
    onehot = torch.nn.functional.one_hot(lab.long(), 2).float()
    mean = cluster_aggregate_tree(stacked, lab, onehot, onehot.sum(0), "mean")
    assert int(lab[1]) == cid
    for got, want in zip(tree_leaves(model), tree_leaves(mean)):
        assert torch.equal(got, want[1])


def test_serve_server_mode_routes_every_client(ckpt, capsys, tmp_path):
    trace = tmp_path / "serve.jsonl"
    report = tserve.main(["--reduced", "--ckpt-dir", str(ckpt[0]),
                          "--server", "--server-callers", "2",
                          "--server-duration", "0.2", "--clusters", "2",
                          "--route-sketch-dim", "16", "--trace", str(trace),
                          "--device", "cpu"])
    assert report["clients"] == 4 and report["n_clusters"] == 2
    assert report["n_errors"] == 0 and report["timeouts"] == 0
    assert sum(report["cluster_sizes"]) == 4
    assert "[server]" in capsys.readouterr().out
    spans = [json.loads(line).get("name") for line in
             trace.read_text().splitlines()]
    assert "session.ingest" in spans


@pytest.mark.parametrize("method", ["ifca", "fedavg"])
def test_simulate_method_matches_reference(method):
    kw = dict(clients=256, clusters=4, method=method, rounds=3)
    want = jsimulate.simulate(**kw)
    got = tsimulate.simulate(device="cpu", **kw)
    for key in ("method", "comm_rounds", "comm_bytes",
                "n_clusters_recovered", "clients"):
        assert got[key] == want[key], key
    if method == "ifca":
        assert got["purity"] == want["purity"] == 1.0
    assert got["serving"] is None
    out = tsimulate.main(["--clients", "256", "--clusters", "4", "--method",
                          method, "--rounds", "2", "--device", "cpu"])
    assert out["comm_rounds"] == 2.0


def test_simulate_refuses_iterative_methods_where_the_reference_does():
    with pytest.raises(ValueError, match="shards"):
        tsimulate.simulate(clients=64, clusters=2, shards=2, method="ifca",
                           device="cpu")
    with pytest.raises(ValueError, match="qps"):
        tsimulate.simulate(clients=64, clusters=2, method="fedavg",
                           qps_callers=2, device="cpu")
