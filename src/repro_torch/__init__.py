"""PyTorch/CUDA port of the smart-exchange federated-learning system.

Mirrors ``src/repro/`` module for module. Entry points run on the CUDA device
unless the caller passes ``device="cpu"``; the hand-written kernels live in
``repro_torch/csrc/`` and are reached through ``repro_torch.kernels.ops``.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless asked otherwise, and
    an error, never a silent CPU run, when no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the host")
    return dev
