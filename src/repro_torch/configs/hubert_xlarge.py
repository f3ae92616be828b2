"""hubert-xlarge [arXiv:2106.07447]

48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 — encoder-only
(bidirectional) transformer backbone; the conv/mel frontend is a stub
per the assignment carve-out (``input_mode='embeddings'``).  vocab=504
is the HuBERT codebook size (masked-frame prediction targets).
Encoder-only => no decode shapes (DESIGN.md §5).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    arch_type="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    mlp_variant="relu",     # w2v2/HuBERT use plain GELU/ReLU FFNs
    causal=False,
    input_mode="embeddings",
    source="arXiv:2106.07447",
)
