"""deepseek-moe-16b [arXiv:2401.06066]

28L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=102400,
fine-grained MoE: 2 shared + 64 routed experts, top-6.
d_ff is the routed-expert hidden size; shared experts are two fused
1408-wide SwiGLU paths (DeepSeekMoE's always-on shared experts).
``serve_window`` enables the sub-quadratic sliding-window serving
variant required by long_500k (beyond-paper serving feature).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    arch_type="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=0,                 # all-MoE layers; experts carry the FFN capacity
    vocab_size=102_400,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    serve_window=4096,
    rope_theta=10_000.0,
    source="arXiv:2401.06066",
)
