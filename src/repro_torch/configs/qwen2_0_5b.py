"""qwen2-0.5b [arXiv:2407.10671]

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936 — GQA with QKV
bias, tied embeddings (the 0.5B variant ties lm_head to the embedding).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    arch_type="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151_936,
    qkv_bias=True,
    tie_embeddings=True,
    serve_window=4096,
    rope_theta=1_000_000.0,
    source="arXiv:2407.10671",
)
