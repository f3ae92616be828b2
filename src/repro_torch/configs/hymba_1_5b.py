"""hymba-1.5b [arXiv:2411.13676]

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16 —
hybrid-head layers: every layer runs attention heads and a Mamba-style
selective-SSM branch in PARALLEL on the same normalized input, fusing
them as the mean of the per-branch RMS-normalized outputs (the paper's
normalized hybrid fusion).  Attention uses a sliding window at serve
time; the SSM branch carries O(1) state => long_500k native.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    arch_type="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32_001,
    block_pattern="hybrid",
    ssm_state=16,
    serve_window=1024,       # Hymba's SWA window
    source="arXiv:2411.13676",
)
