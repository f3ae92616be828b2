"""The dense decoder LM of the reference's ``models`` package, in PyTorch
(prefill through the hand-written flash-attention kernel)."""
from repro_torch.models.transformer import (
    DecodeCache,
    decode_step,
    forward,
    init_decode_cache,
    init_params,
)

__all__ = [
    "DecodeCache",
    "decode_step",
    "forward",
    "init_decode_cache",
    "init_params",
]
