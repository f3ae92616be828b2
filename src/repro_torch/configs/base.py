"""Architecture + run configuration dataclasses.

``ModelConfig`` is the single source of truth consumed by
``repro_torch.models``: every assigned architecture is expressed as an
instance (one module per arch under ``repro_torch/configs/``).  These
are plain data, a copy of the reference package's configs, so the port
imports nothing of it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    mlp_variant: str = "swiglu"    # swiglu | geglu | relu
    qkv_bias: bool = False
    causal: bool = True            # False -> encoder-only (bidirectional)
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0              # routed expert hidden size
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # --- recurrent / hybrid ---
    block_pattern: str = "attn"    # attn | xlstm | hybrid
    ssm_state: int = 0             # mamba state size (hybrid)
    conv_width: int = 4            # mamba short conv width
    # --- attention geometry ---
    window: Optional[int] = None        # training attention window
    serve_window: Optional[int] = None  # decode cache window for long ctx
    rope_theta: float = 10_000.0
    # --- implementation knobs (not architecture identity) ---
    attn_chunk: int = 1024         # flash-style chunk; 0 = direct einsum
    mlstm_chunk: int = 256         # mLSTM chunkwise width; 0 = one chunk
    ssm_chunk: int = 256           # selective-scan chunk; 0 = one assoc scan
    splitk_decode: bool = False    # shard decode KV cache length over model
    # --- misc ---
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # inputs: 'tokens' | 'embeddings' (audio frontend stub) | 'multimodal'
    input_mode: str = "tokens"
    source: str = ""               # provenance citation

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    def reduced(self, *, n_layers: int = 2, max_d_model: int = 512,
                max_experts: int = 4, max_vocab: int = 1024) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests."""
        scale = min(1.0, max_d_model / self.d_model)
        d_model = max(64, int(self.d_model * scale) // 32 * 32)
        n_heads = max(2, min(self.n_heads, d_model // 32))
        ratio = max(1, self.n_heads // max(1, self.n_kv_heads))
        n_kv_heads = max(1, n_heads // ratio)
        while n_heads % n_kv_heads:
            n_kv_heads -= 1
        head_dim = d_model // n_heads
        updates = dict(
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv_heads,
            head_dim=head_dim,
            d_ff=max(32, int(self.d_ff * scale)) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, max_vocab),
            dtype="float32",
        )
        if self.is_moe:
            updates.update(
                n_experts=min(self.n_experts, max_experts),
                top_k=min(self.top_k, min(self.n_experts, max_experts)),
                moe_d_ff=max(32, int(self.moe_d_ff * scale)),
            )
        if self.window:
            updates["window"] = min(self.window, 64)
        if self.serve_window:
            updates["serve_window"] = min(self.serve_window, 64)
        return dataclasses.replace(self, **updates)


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One of the four assigned global input shapes."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # 'train' | 'prefill' | 'decode'


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
