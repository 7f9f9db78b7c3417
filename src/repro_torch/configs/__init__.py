"""Config registry: ``get_config(arch_id)`` / ``get_smoke_config(arch_id)``.

Holds the JAX package's ten architectures: the dense GQA family, the MoE
family, xLSTM, the RG-LRU hybrid, the vision-stub qwen2-vl and the
audio-codec musicgen."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (INPUT_SHAPES, InputShape, ModelConfig,
                                      TrainConfig)

_MODULES = {
    "qwen2-vl-72b": "qwen2_vl_72b",
    "llama3.2-1b": "llama32_1b",
    "llama3.2-3b": "llama32_3b",
    "llama3-8b": "llama3_8b",
    "xlstm-125m": "xlstm_125m",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "qwen2-moe-a2.7b": "qwen2_moe_a27b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b",
    "musicgen-medium": "musicgen_medium",
}

ARCH_IDS = tuple(_MODULES)


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()


__all__ = [
    "ARCH_IDS",
    "INPUT_SHAPES",
    "InputShape",
    "ModelConfig",
    "TrainConfig",
    "get_config",
    "get_smoke_config",
]
