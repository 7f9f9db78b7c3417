"""Config registry: ``get_config(arch_id)`` / ``get_smoke_config(arch_id)``.

Holds the architectures whose blocks the port runs: the dense GQA family.
The JAX package's MoE, recurrent, vision and audio configs come with their
families (ROADMAP Queue 1)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "llama3.2-1b": "llama32_1b",
    "llama3.2-3b": "llama32_3b",
    "llama3-8b": "llama3_8b",
}

ARCH_IDS = tuple(_MODULES)


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown or unported arch {arch_id!r}; ported: "
                       f"{sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()


__all__ = [
    "ARCH_IDS",
    "ModelConfig",
    "get_config",
    "get_smoke_config",
]
