"""The reference's ``models`` package in PyTorch: every architecture
family of ``configs/`` (dense, MoE, xLSTM, hybrid attention + SSM, audio
and multimodal inputs); prefill through the hand-written flash-attention
kernel, training through the differentiable attention."""
from repro_torch.models.transformer import (
    DecodeCache,
    abstract_params,
    decode_step,
    forward,
    init_decode_cache,
    init_params,
    init_tree,
    model_view,
    train_loss,
)

__all__ = [
    "DecodeCache",
    "abstract_params",
    "decode_step",
    "forward",
    "init_decode_cache",
    "init_params",
    "init_tree",
    "model_view",
    "train_loss",
]
