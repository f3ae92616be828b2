"""Batched serving driver: prefill + autoregressive generation over the
decode cache, of a freshly initialised causal decoder over tokens (dense,
MoE, xLSTM or hybrid attention + SSM) or of a model from a federated
checkpoint.  Encoder-only and multimodal configurations are refused.

The prompt pass runs the hand-written flash-attention kernel on the
card (once per layer); decode reads the cache one token at a time.

Two ways to pick the served model from a stacked federated checkpoint
(``--ckpt-dir``, as ``launch.train`` writes it, in either package):

  * ``--client i``: the client's own slice;
  * ``--route-by-sketch``: the paper's serving rule.  The stacked
    parameters go into an ``AggregationSession``, the registered
    clustering runs over their sketches, the client's sketch is routed
    to its nearest recovered cluster, and that cluster's averaged model
    is served (step 4 of Algorithm 1 at serving time).

``--server`` puts the rebuilt session behind a ``RouteServer`` and routes
every checkpointed client from concurrent caller threads (a synthetic
stacked checkpoint without ``--ckpt-dir``).

  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \\
      --ckpt-dir ckpt --route-by-sketch --clusters 2 --client 1
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --batch 4 --prompt-len 8192 --gen 64            # on the card
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import obs, runtime
from repro_torch.checkpoint import latest_step, restore_checkpoint
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import decode_step, init_params
from repro_torch.models.transformer import (
    model_view,
    prefill_with_cache,
    tree_from_model,
)
from repro_torch.utils import tree_leaves, tree_map


class _StepClock:
    """Marks after each step: CUDA events on the card (no host sync in
    the loop), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> list:
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in zip(self.marks,
                                                      self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def generate(model, cfg, prompts: torch.Tensor, gen: int, *,
             temperature: float = 0.0,
             generator: torch.Generator | None = None, device=None):
    """prompts (b, s) -> (b, s + gen) tokens + timing stats, on
    ``device`` (CUDA unless "cpu"; the model and the prompts must lie
    there).

    The first new token is the prefill's argmax; the next gen - 1 come
    from decode steps, greedy at temperature 0, else drawn with
    ``torch.multinomial`` from ``generator`` (default: one seeded with 0
    on the prompts' device).  Stats: ``prefill_s``, ``decode_s``,
    ``tok_per_s`` (b (gen - 1) / decode_s) and ``decode_ms``, the time of
    each decode step.
    """
    b, s = prompts.shape
    if cfg.input_mode != "tokens":
        raise ValueError(f"generate feeds token prompts only; {cfg.name} "
                         f"takes {cfg.input_mode} inputs")
    dev = resolve_device(device)
    for what, where in (("prompts", prompts.device),
                        ("model", model.embed.device)):
        if where != dev:
            raise ValueError(f"generate runs on {dev}; the {what} lie on "
                             f"{where}")
    if temperature > 0 and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill_with_cache(model, cfg, {"tokens": prompts},
                                       capacity=s + gen)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    del logits            # (b, s, V): the largest buffer of the run
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out = [tok]
    clock = _StepClock(dev)
    t0 = time.perf_counter()
    clock.mark()
    for _ in range(gen - 1):
        lg, cache = decode_step(model, cfg, cache, tok)
        if temperature > 0:
            probs = torch.softmax(lg[:, -1].float() / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)
        else:
            tok = torch.argmax(lg[:, -1:], dim=-1)
        out.append(tok)
        clock.mark()
    step_ms = clock.intervals_ms()
    _sync(dev)
    t_decode = time.perf_counter() - t0
    tokens = torch.cat([prompts] + out, dim=1)
    return tokens, {"prefill_s": t_prefill, "decode_s": t_decode,
                    "tok_per_s": b * (gen - 1) / max(t_decode, 1e-9),
                    "decode_ms": step_ms}


def route_from_checkpoint(stacked, cfg, client: int, *, algorithm: str,
                          clusters: int, sketch_dim: int, seed: int = 0,
                          device=None):
    """Cluster a stacked federated parameter tree and pick the served
    model by sketch routing.  Returns (cluster model tree, cluster id,
    info with the labels)."""
    from repro_torch.core.engine.session import AggregationSession

    n = int(tree_leaves(stacked)[0].shape[0])
    session = AggregationSession(n, sketch_dim=sketch_dim, cfg=cfg,
                                 seed=seed, device=device)
    session.ingest(stacked)
    _, labels, info = session.finalize(algorithm=algorithm, k=clusters,
                                       engine="device")
    cid = session.route(params=tree_map(lambda l: l[client], stacked))
    if not 0 <= cid < session.n_clusters:
        raise SystemExit(f"routed cluster id {cid} out of range for "
                         f"{session.n_clusters} recovered clusters")
    return session.cluster_model(cid), cid, {"labels": labels, **info}


def serve_routes(stacked, cfg, *, algorithm: str, clusters: int,
                 sketch_dim: int, callers: int, duration_s: float,
                 seed: int = 0, device=None) -> dict:
    """``--server``: rebuild the cluster structure from a stacked tree as
    ``route_from_checkpoint`` does, put the session behind a
    ``RouteServer`` and route every client's sketch, then run a closed
    loop of ``callers`` threads for ``duration_s``.  Returns a report."""
    from repro_torch.core.engine.session import AggregationSession
    from repro_torch.serving.loadgen import closed_loop, warm_route_buckets
    from repro_torch.serving.server import RouteServer

    n = int(tree_leaves(stacked)[0].shape[0])
    session = AggregationSession(n, sketch_dim=sketch_dim, cfg=cfg,
                                 seed=seed, device=device)
    session.ingest(stacked)
    session.finalize(algorithm=algorithm, k=clusters, engine="device")
    probes = session.sketch_params(stacked).cpu().numpy()
    max_batch = min(32, max(1, n))
    warm_route_buckets(session, probes[0], max_batch)
    with RouteServer(session, max_batch=max_batch, max_wait_ms=0.5) as srv:
        routed = [srv.route(p, timeout=30.0) for p in probes]
        stats = closed_loop(srv, probes, callers=callers,
                            duration_s=duration_s, batched=True)
    counts = np.bincount(routed, minlength=session.n_clusters)
    return {"clients": n, "n_clusters": session.n_clusters,
            "routed": routed, "cluster_sizes": counts.tolist(),
            "callers": callers, **stats}


def _restore_stacked(ckpt_dir: str, template: dict, dev):
    """(step, the stacked tree on ``dev`` in the template's dtypes, and
    whether it has a client axis)."""
    step = latest_step(ckpt_dir)
    if step is None:
        raise SystemExit(f"no checkpoints found in {ckpt_dir}")
    restored = restore_checkpoint(ckpt_dir, step, template)
    stacked = (tree_leaves(restored)[0].shape
               != tree_leaves(template)[0].shape)
    return step, tree_map(lambda l, r: l.to(dev, r.dtype), restored,
                          template), stacked


def _synthetic_stacked(template: dict, n: int, k: int, gen):
    """A synthetic stacked checkpoint: per-cluster offsets plus small
    per-client noise around the template, so routing has structure."""
    group = torch.arange(n, device=gen.device) % k

    def leaf(l):
        offs = torch.randn((k,) + tuple(l.shape), generator=gen,
                           device=gen.device).to(l.dtype)
        noise = 0.05 * torch.randn((n,) + tuple(l.shape), generator=gen,
                                   device=gen.device).to(l.dtype)
        return l[None] + offs[group] + noise

    return tree_map(leaf, template)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--client", type=int, default=0,
                    help="which client to serve from a stacked federated "
                         "checkpoint (its slice, or with --route-by-sketch "
                         "its routed cluster model)")
    ap.add_argument("--route-by-sketch", action="store_true",
                    help="rebuild the cluster structure from the stacked "
                         "checkpoint (AggregationSession) and serve the "
                         "cluster model the client's sketch routes to")
    ap.add_argument("--clusters", type=int, default=2,
                    help="k for the routing clustering (--route-by-sketch)")
    ap.add_argument("--route-algorithm", default="kmeans-device",
                    help="registered clustering for --route-by-sketch")
    ap.add_argument("--route-sketch-dim", type=int, default=64)
    ap.add_argument("--server", action="store_true",
                    help="route ALL clients of the stacked checkpoint "
                         "through a RouteServer with concurrent callers; "
                         "without --ckpt-dir a synthetic stacked "
                         "checkpoint is generated")
    ap.add_argument("--server-callers", type=int, default=4,
                    help="closed-loop caller threads for --server")
    ap.add_argument("--server-duration", type=float, default=2.0,
                    help="seconds of closed-loop load for --server")
    ap.add_argument("--server-clients", type=int, default=16,
                    help="synthetic stacked-checkpoint size for --server "
                         "without --ckpt-dir")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write every obs span/event (routing, finalize) "
                         "of this serve run as JSONL")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    return ap


def main(argv=None):
    runtime.apply_env_presets()          # REPRO_CPU_THREADS
    args = parser().parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(max_vocab=256)
    if cfg.is_encoder_only:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode serving")
    if cfg.input_mode == "multimodal":
        raise SystemExit(
            f"{cfg.name} takes image patch embeddings (patch_embeds, "
            "patch_positions) beside its tokens; launch.serve feeds "
            "token prompts only (prefill_with_cache takes a batch with them)")
    dev = resolve_device(args.device)
    sink = obs.add_sink(obs.JsonlSink(args.trace)) if args.trace else None
    try:
        return _serve(args, cfg, dev)
    finally:
        if sink is not None:
            obs.remove_sink(sink)
            sink.close()


def _serve(args, cfg, dev):
    model = init_params(cfg, seed=args.seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    if args.server:
        template = tree_from_model(model)
        if args.ckpt_dir:
            step, stacked, is_stacked = _restore_stacked(args.ckpt_dir,
                                                         template, dev)
            if not is_stacked:
                raise SystemExit("--server needs a stacked federated "
                                 "checkpoint (leading client axis); this "
                                 "one is a single model")
            src = (f"checkpoint step {step} "
                   f"({tree_leaves(stacked)[0].shape[0]} clients)")
        else:
            stacked = _synthetic_stacked(template, args.server_clients,
                                         args.clusters, gen)
            src = f"{args.server_clients} synthetic clients"
        report = serve_routes(
            stacked, cfg, algorithm=args.route_algorithm,
            clusters=args.clusters, sketch_dim=args.route_sketch_dim,
            callers=args.server_callers, duration_s=args.server_duration,
            seed=args.seed, device=dev)
        print(f"[server] {src}: K'={report['n_clusters']} "
              f"cluster sizes {report['cluster_sizes']}")
        print(f"[server] {report['callers']} callers  "
              f"{report['qps']:.0f} routes/s  "
              f"p50={report['route_p50_ms']:.2f}ms "
              f"p99={report['route_p99_ms']:.2f}ms  "
              f"errors={report['n_errors']} timeouts={report['timeouts']}")
        return report

    if args.ckpt_dir:
        template = tree_from_model(model)
        step, stacked, is_stacked = _restore_stacked(args.ckpt_dir, template,
                                                     dev)
        del model
        if args.route_by_sketch:
            if not is_stacked:
                raise SystemExit("--route-by-sketch needs a stacked "
                                 "federated checkpoint (leading client "
                                 "axis); this one is a single model")
            n = tree_leaves(stacked)[0].shape[0]
            if not 0 <= args.client < n:
                raise SystemExit(f"client index {args.client} out of range "
                                 f"for {n} checkpointed clients")
            params, cid, info = route_from_checkpoint(
                stacked, cfg, args.client, algorithm=args.route_algorithm,
                clusters=args.clusters, sketch_dim=args.route_sketch_dim,
                seed=args.seed, device=dev)
            print(f"[ckpt] restored step {step}; client {args.client} "
                  f"routed to cluster {cid}/{info['n_clusters']} "
                  f"(labels {info['labels'].tolist()})")
            h = obs.snapshot()["histograms"].get("session.route.ms")
            if h and h.get("count"):
                print(f"[route] {h['count']} request(s), "
                      f"p50={h['p50']:.3f}ms max={h['max']:.3f}ms")
        else:
            if is_stacked:
                n = tree_leaves(stacked)[0].shape[0]
                if not 0 <= args.client < n:
                    raise SystemExit(f"client index {args.client} out of "
                                     f"range for {n} checkpointed clients")
                params = tree_map(lambda l: l[args.client], stacked)
            else:
                params = stacked
            print(f"[ckpt] restored step {step} (client {args.client})")
        model = model_view(params, cfg)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=dev)
    tokens, stats = generate(model, cfg, prompts, args.gen,
                             temperature=args.temperature, generator=gen,
                             device=dev)
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen}")
    print(f"prefill {stats['prefill_s']*1e3:.1f}ms  "
          f"decode {stats['decode_s']*1e3:.1f}ms  "
          f"throughput {stats['tok_per_s']:.1f} tok/s")
    print("sample row:", tokens[0, -args.gen:].tolist())
    return tokens


if __name__ == "__main__":
    main()
