"""grok-1-314b [hf:xai-org/grok-1]

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072,
MoE 8 experts top-2.  d_ff is the per-expert hidden size (Grok's MoE
FFN).  The flagship scale config: requires FSDP over the data (+pod)
axes on top of tensor parallelism to fit (see the reference package's
sharding).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    arch_type="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=0,
    vocab_size=131_072,
    n_experts=8,
    n_shared_experts=0,
    top_k=2,
    moe_d_ff=32_768,
    serve_window=4096,
    source="hf:xai-org/grok-1",
)
