"""Assigned architecture configs (one module per arch) + registry."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig

ARCH_IDS = [
    "deepseek_moe_16b",
    "hubert_xlarge",
    "qwen2_0_5b",
    "pixtral_12b",
    "xlstm_125m",
    "grok_1_314b",
    "gemma_2b",
    "hymba_1_5b",
    "moonshot_v1_16b_a3b",
    "yi_9b",
]

# CLI ids (with dashes) -> module names
ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}
ALIASES.update({
    "deepseek-moe-16b": "deepseek_moe_16b",
    "qwen2-0.5b": "qwen2_0_5b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "hymba-1.5b": "hymba_1_5b",
})


def get_config(arch: str) -> ModelConfig:
    mod_name = ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


__all__ = ["ModelConfig", "InputShape", "INPUT_SHAPES", "ARCH_IDS",
           "get_config", "all_configs"]
