"""pixtral-12b [hf:mistralai/Pixtral-12B-2409]

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072 — the
Mistral-Nemo-style multimodal decoder (head_dim=128).  The Pixtral ViT
vision encoder + projector is a stub per the assignment carve-out:
``input_mode='multimodal'`` consumes precomputed patch embeddings
scattered into the token sequence at given positions.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    arch_type="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131_072,
    input_mode="multimodal",
    serve_window=4096,
    rope_theta=1_000_000.0,
    source="hf:mistralai/Pixtral-12B-2409",
)
