"""moonshot-v1-16b-a3b [hf:moonshotai/Moonlight-16B-A3B]

48L d_model=2048 16H (kv=16) d_ff=1408 vocab=163840, MoE 64 experts
top-6 (+2 shared) — Moonlight's DeepSeek-V3-style fine-grained MoE at
16B total / ~3B active parameters.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    arch_type="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=0,
    vocab_size=163_840,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    serve_window=4096,
    rope_theta=50_000.0,
    source="hf:moonshotai/Moonlight-16B-A3B",
)
