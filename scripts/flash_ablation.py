"""Where the bf16 flash-attention kernel's time goes, by ablation, on the GPU.

    python3 scripts/flash_ablation.py

Builds ``src/repro_torch/kernels/csrc/flash_attention.cu`` as it is and
with one part of the tensor-core kernel taken out at a time, and times
each build at the serve shape (q (4, 14, 8192, 64) x kv (4, 2, 8192, 64),
bf16, causal, window 4096) by CUDA events:

* ``kernel``: the kernel as it is;
* ``no_exp``: exp2 replaced by the identity (the exponentials' share);
* ``no_lo_product``: the P_lo . V product dropped (the split's cost);
* ``no_softmax``: the softmax replaced by a copy of the logits;
* ``no_products``: Q K^T and P V not issued (softmax and the rest);
* ``loads_only``: neither the products nor the softmax (TMA loads,
  barriers, the P split and the output).

The ablated builds compute wrong outputs; only their times mean
anything.  Each build goes to ``kernels/build/ablation/<name>/``
(git-ignored).  Prints one JSON line per build and the card's name and
power limit.  Needs a CUDA device; imports no JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as flash  # noqa: E402

PV = "        issue_pv<NC, BK>(o, p_hi, p_lo, stage + L::kTileBytes);\n"
QK = "        issue_qk<NC, BK>(s, q_rows, stage, qk_steps);\n"
QK_FILL = ("#pragma unroll\n        for (int j = 0; j < BK / 2; ++j) "
           "s[j] = 0.01f * j + 0.001f * kt;\n")
SOFTMAX = ("        softmax_tile<BK>(s, pr, st, alpha_a, alpha_b, p, kt, "
           "all_live, c_log2,\n                         lane);\n")
SKIP = ("#pragma unroll\n        for (int j = 0; j < BK / 2; ++j) "
        "pr[j] = s[j];\n        alpha_a = alpha_b = 1.f;\n")
ABLATIONS = {
    "kernel": [],
    "no_exp": [('  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
                "  y = x;")],
    "no_lo_product": [("      wgmma_rs(o[c], p_lo[t], dv);\n", "")],
    "no_softmax": [(SOFTMAX, SKIP)],
    "no_products": [(PV, ""), (QK, QK_FILL)],
    "loads_only": [(PV, ""), (QK, QK_FILL), (SOFTMAX, SKIP)],
}


def cuda_time_ms(fn, reps: int = 20) -> float:
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("flash_ablation: no CUDA device")
    source = (_build.CSRC / "flash_attention.cu").read_text()
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(s, generator=gen, device="cuda").bfloat16()
               .transpose(1, 2)
               for s in [(4, 8192, 14, 64), (4, 8192, 2, 64),
                         (4, 8192, 2, 64)])
    for name, edits in ABLATIONS.items():
        text = source
        for old, new in edits:
            if old not in text:
                sys.exit(f"flash_ablation: {name}: the source no longer "
                         f"holds {old!r}")
            text = text.replace(old, new)
        where = _build.BUILD_DIR / "ablation" / name
        where.mkdir(parents=True, exist_ok=True)
        (where / "flash_attention.cu").write_text(text)
        _build.CSRC = where
        _build.load.cache_clear()
        ms = [cuda_time_ms(lambda: flash.flash_attention(
            q, k, v, causal=True, window=4096)) for _ in range(3)]
        usage = {fn: u for fn, u in _build.ptxas_usage(
            "flash_attention").items() if "tcILi1ELi128E" in fn}
        print(json.dumps({"ablation": name, "ms": ms,
                          "ptxas_tc_dh64": list(usage.values())}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
