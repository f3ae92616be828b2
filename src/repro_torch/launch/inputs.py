"""``input_specs``: stand-ins for every model input (the port of
``repro/launch/inputs.py``).

Each leaf is a ``device="meta"`` tensor of the reference's shape and
dtype (the reference's ``ShapeDtypeStruct``): nothing is allocated.
This is all the dry run needs to place and trace a step.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.models import transformer as tr
from repro_torch.utils import tree_map

__all__ = ["INPUT_SHAPES", "N_PATCHES", "abstract_opt_state",
           "decode_input_specs", "input_specs", "prefill_input_specs",
           "serve_config", "shape_supported", "sds", "train_input_specs"]

N_PATCHES = 256          # stub vision patch count per sequence


def sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def serve_config(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Shape-dependent serving variant of an arch config.

    decode_32k keeps the FULL 32k KV cache (the assignment's definition);
    long_500k selects the sliding-window variant for attention archs
    (cap = serve_window) -- recurrent archs carry O(1) state natively.
    """
    if shape.name == "decode_32k":
        return dataclasses.replace(cfg, serve_window=None)
    return cfg


def shape_supported(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """(supported, reason-if-skipped) per the assignment skip rules."""
    if shape.kind == "decode" and cfg.is_encoder_only:
        return False, "encoder-only: no autoregressive decode step"
    if shape.name == "long_500k":
        sub_quadratic = (cfg.block_pattern in ("xlstm", "hybrid")
                         or cfg.serve_window is not None)
        if not sub_quadratic:
            return False, "pure full-attention arch: quadratic at 500k"
    return True, ""


def train_input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    b, s = shape.global_batch, shape.seq_len
    dtype = tr.torch_dtype(cfg)
    if cfg.input_mode == "tokens":
        return {"tokens": sds((b, s), torch.int32),
                "labels": sds((b, s), torch.int32)}
    if cfg.input_mode == "embeddings":
        return {"frames": sds((b, s, tr.FRONTEND_DIM), dtype),
                "mask": sds((b, s), torch.bool),
                "labels": sds((b, s), torch.int32)}
    if cfg.input_mode == "multimodal":
        return {"tokens": sds((b, s), torch.int32),
                "patch_embeds": sds((b, N_PATCHES, tr.PATCH_DIM), dtype),
                "patch_positions": sds((b, N_PATCHES), torch.int32),
                "labels": sds((b, s), torch.int32)}
    raise ValueError(cfg.input_mode)


def prefill_input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    specs = train_input_specs(cfg, shape)
    specs.pop("labels")
    if cfg.input_mode == "embeddings":
        specs.pop("mask")
    return specs


def decode_input_specs(cfg: ModelConfig, shape: InputShape):
    """(cache, tokens) for one-token decode against a seq_len cache: the
    port's ``DecodeCache`` (per-layer dicts, ``pos`` an int) of meta
    tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    scfg = serve_config(cfg, shape)
    with FakeTensorMode():
        cache = tr.init_decode_cache(scfg, shape.global_batch, shape.seq_len,
                                     device="cpu")
    cache = cache._replace(layers=tree_map(
        lambda t: sds(t.shape, t.dtype), cache.layers))
    return cache, sds((shape.global_batch, 1), torch.int32)


def abstract_opt_state(params_sds):
    from repro_torch.optim import adamw_init

    return adamw_init(params_sds)


def input_specs(cfg: ModelConfig, shape: InputShape):
    """The full input bundle for the step matching ``shape.kind``."""
    params = tr.abstract_params(cfg)
    if shape.kind == "train":
        return {"params": params,
                "opt_state": abstract_opt_state(params),
                "batch": train_input_specs(cfg, shape)}
    if shape.kind == "prefill":
        return {"params": params, "batch": prefill_input_specs(cfg, shape)}
    cache, tokens = decode_input_specs(cfg, shape)
    return {"params": params, "cache": cache, "tokens": tokens}
