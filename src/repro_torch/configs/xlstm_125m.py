"""xlstm-125m [arXiv:2405.04517]

12L d_model=768 4H d_ff=0 vocab=50304 — alternating sLSTM + mLSTM
blocks.  Our stacking pairs one mLSTM and one sLSTM block per scan step
(12 layers = 6 pairs), matching the paper's mixed xLSTM[m:s] stacks while
keeping the layer scan homogeneous (DESIGN.md §3).  d_ff=0: xLSTM blocks
carry their own up/down projections instead of a separate FFN.
Fully recurrent => native sub-quadratic long_500k decode.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    arch_type="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50_304,
    block_pattern="xlstm",
    tie_embeddings=True,
    source="arXiv:2405.04517",
)
