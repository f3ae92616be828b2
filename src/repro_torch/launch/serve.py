"""Batched serving driver: prefill + autoregressive generation over the
ring-buffer KV cache, with a freshly initialised dense decoder LM.

The prompt pass runs the hand-written flash-attention kernel on the
card (once per layer); decode reads the cache one token at a time.

  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --batch 4 --prompt-len 8192 --gen 64            # on the card

Not ported yet: serving from a checkpoint (``--ckpt-dir``, ``--client``),
``--route-by-sketch``, ``--server`` and ``--trace``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import decode_step, init_params
from repro_torch.models.transformer import prefill_with_cache


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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(max_vocab=256)
    if cfg.is_encoder_only:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode serving")
    dev = resolve_device(args.device)
    model = init_params(cfg, seed=args.seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
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
