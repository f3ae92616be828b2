"""gemma-2b [arXiv:2403.08295]

18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000 — GeGLU MLP,
head_dim=256 (8 x 256 = 2048), multi-query attention, tied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    arch_type="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16_384,
    vocab_size=256_000,
    mlp_variant="geglu",
    tie_embeddings=True,
    serve_window=4096,
    source="arXiv:2403.08295",
)
