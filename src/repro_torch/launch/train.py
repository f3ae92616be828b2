"""Federated training driver over the LM-scale method registry (the port
of ``repro/launch/train.py``).

Runs any registered ``FederatedMethod`` (``core.federated_methods``) on
a clustered LM federation: ODCL's one-shot protocol (local training,
ONE clustered round, optional personalized steps), the iterative IFCA
baseline, global FedAvg or local-only, chosen with ``--method``.  Runs
on the card unless ``--device cpu``.

  # Algorithm 1, host clustering (ODCL-KM++), reduced model on the CPU:
  PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
      --clients 4 --clusters 2 --local-steps 8 --post-steps 2 \\
      --seq-len 16 --batch 2 --ckpt-dir ckpt --device cpu

  # full qwen2-0.5b on the card, the whole round on the device:
  PYTHONPATH=src python -m repro_torch.launch.train --method odcl \\
      --engine device --algo kmeans++ --local-steps 20 --post-steps 2

  # the iterative baseline with the sketch assignment:
  PYTHONPATH=src python -m repro_torch.launch.train --method ifca \\
      --ifca-assign sketch --rounds 2 --local-steps 2

``train(argv, mesh=)`` (no CLI flag, as ``simulate``'s) runs the same
federation with its client axis sharded over a mesh, one process a rank
(``launch.mesh.client_mesh``): each rank builds, trains and evaluates
its own clients, and every rank returns the whole run's labels and
losses; rank 0 prints.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import obs
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config
from repro_torch.core.clustering import list_algorithms
from repro_torch.core.engine.aggregators import list_aggregators
from repro_torch.core.federated import evaluate_per_client, init_federation
from repro_torch.core.federated_methods import (
    build_federated_method,
    cluster_agreement,
    list_federated_methods,
)
from repro_torch.data import ClusteredTokenStream, make_lm_batch_iterator
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_eval_batch
from repro_torch.optim import AdamWConfig
from repro_torch.sharding.clients import client_axis_of


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized same-family variant")
    ap.add_argument("--method", default="odcl",
                    choices=list(list_federated_methods()),
                    help="registered FederatedMethod to run")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--clusters", type=int, default=2)
    ap.add_argument("--local-steps", type=int, default=100)
    ap.add_argument("--post-steps", type=int, default=20,
                    help="continued local steps after aggregation (odcl)")
    ap.add_argument("--rounds", type=int, default=5,
                    help="communication rounds (ifca / fedavg)")
    ap.add_argument("--warmup-steps", type=int, default=0,
                    help="pure local steps before the round loop (ifca)")
    ap.add_argument("--ifca-assign", choices=("loss", "sketch"),
                    default="loss", dest="assign",
                    help="IFCA cluster-estimate rule")
    ap.add_argument("--ifca-carry-opt", action="store_true",
                    dest="carry_opt_state",
                    help="FedOpt-style IFCA: carry per-cluster Adam "
                         "moments across rounds")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--algo", default="kmeans++",
                    choices=list(list_algorithms()),
                    help="admissible clustering algorithm; with --engine "
                         "device the Lloyd names map onto kmeans-device "
                         "and convex/clusterpath onto their -device twins")
    ap.add_argument("--engine", choices=("host", "device"), default="host",
                    help="device = the whole one-shot round on the device "
                         "(engine.one_shot_aggregate_device)")
    ap.add_argument("--restarts", type=int, default=1,
                    help="multi-restart Lloyd for the device kmeans family")
    ap.add_argument("--batch-m", type=int, default=None,
                    help="minibatch Lloyd: sketch rows per iteration "
                         "(device kmeans family)")
    ap.add_argument("--sketch-dim", type=int, default=128)
    ap.add_argument("--aggregator", default="mean",
                    choices=list(list_aggregators()),
                    help="per-cluster step-3 reduction (odcl / ifca)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write every obs span/event of this run as JSONL")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    return ap


def train(argv=None, *, mesh=None) -> dict:
    """Parse ``argv``, run the method, print the reference driver's lines
    and return a summary: the ``FederatedMethodResult`` (``result``), the
    token ``stream``, the eval losses, ``seconds`` and ``purity``.
    ``mesh``: the client axis sharded over the mesh's one dim (the
    state's leaves are then ``Shard(0)`` DTensors, and the method finds
    the axis on them)."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    sink = obs.add_sink(obs.JsonlSink(args.trace)) if args.trace else None
    try:
        return _train(args, dev, mesh)
    finally:
        if sink is not None:
            obs.remove_sink(sink)
            sink.close()


def main(argv=None):
    """The CLI: returns (final state, labels), as the reference's does."""
    out = train(argv)
    return out["result"].state, np.asarray(out["result"].labels)


def _train(args, dev, mesh) -> dict:
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(max_vocab=256)
    # every rank runs this same code; rank 0 speaks for it
    quiet = client_axis_of(mesh).rank != 0
    say = (lambda *a, **k: None) if quiet else print
    say(f"arch={cfg.name} d_model={cfg.d_model} L={cfg.n_layers} "
        f"vocab={cfg.vocab_size} clients={args.clients} "
        f"true_clusters={args.clusters} method={args.method}")

    stream = ClusteredTokenStream(
        n_clients=args.clients, n_clusters=args.clusters,
        vocab_size=cfg.vocab_size, seed=args.seed)
    batches = make_lm_batch_iterator(
        stream, clients_per_batch=list(range(args.clients)),
        per_client_batch=args.batch, seq_len=args.seq_len)
    it = ({"tokens": toks, "labels": labels} for toks, labels in batches)
    opt = AdamWConfig(lr=args.lr, weight_decay=0.0)
    state = init_federation(args.seed, cfg, args.clients, device=dev,
                            mesh=mesh)

    algo_options = {}
    if args.restarts > 1:
        algo_options["restarts"] = args.restarts
    if args.batch_m is not None:
        algo_options["batch_m"] = args.batch_m
    if algo_options and (args.engine != "device"
                         or args.algo.startswith(("convex", "clusterpath"))):
        say(f"[warn] {sorted(algo_options)} only apply to the device "
            f"kmeans family; ignored for --engine {args.engine} "
            f"--algo {args.algo}")
        algo_options = {}

    method = build_federated_method(
        args.method, algorithm=args.algo, k=args.clusters,
        engine=args.engine, sketch_dim=args.sketch_dim,
        algo_options=algo_options or None,
        local_steps=args.local_steps, post_steps=args.post_steps,
        rounds=args.rounds, warmup_steps=args.warmup_steps,
        assign=args.assign, carry_opt_state=args.carry_opt_state,
        aggregator=args.aggregator, opt=opt, seed=args.seed)

    t0 = time.time()
    res = method.run(args.seed, state, cfg, it)
    elapsed = time.time() - t0
    for r in res.round_metrics:
        # the reference's line; the per-client losses stay in the result
        say(f"[{method.name}] "
            f"{ {k: v for k, v in r.items() if k != 'client_losses'} }")
    agreement = cluster_agreement(res.labels, stream.true_labels)
    say(f"[{method.name}] {elapsed:.1f}s  rounds={res.comm_rounds:g} "
        f"comm={res.comm_bytes / 1e6:.2f}MB  K'={res.n_clusters} "
        f"cluster purity={agreement:.3f} labels={res.labels.tolist()}")

    eval_batch = make_eval_batch(stream, n_clients=args.clients,
                                 batch=args.batch, seq_len=args.seq_len)
    final_eval = evaluate_per_client(res.state, cfg, eval_batch)
    say(f"[eval] per-client loss {final_eval.mean():.4f} "
        f"(min {final_eval.min():.4f} max {final_eval.max():.4f})")

    if args.ckpt_dir:
        path = save_checkpoint(args.ckpt_dir, res.state.step, res.state.params)
        say(f"[ckpt] saved {path}")
    return {"result": res, "stream": stream, "eval_loss": final_eval,
            "seconds": elapsed, "purity": agreement, "cfg": cfg}


if __name__ == "__main__":
    main()
