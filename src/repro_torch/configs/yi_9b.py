"""yi-9b [arXiv:2403.04652]

48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000 — llama-style
dense decoder with GQA and SwiGLU.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    arch_type="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=11_008,
    vocab_size=64_000,
    serve_window=4096,
    rope_theta=10_000.0,
    source="arXiv:2403.04652",
)
