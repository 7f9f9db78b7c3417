"""Architecture configuration dataclass (the port's own copy of
``repro.configs.base``; ``act_dtype`` and ``p_dtype`` give torch dtypes).

Every ported architecture gets a ``configs/<id>.py`` exporting ``CONFIG``
(the exact full-size config) and ``smoke_config()`` (the reduced variant used
by CPU tests: <= 2 layers, d_model <= 512).

Only the fields the dense transformer reads are here, plus the switches that
select an unported family (``n_experts``, ``block_pattern``, ``frontend``,
``mrope_sections``, ``act_seq_shard``): the model raises
``NotImplementedError`` naming ROADMAP when one of those is set. The other
families' knobs, ``InputShape`` and ``TrainConfig`` come with the PRs that
read them (ROADMAP Queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # --- MoE (unported: > 0 raises) ---
    n_experts: int = 0

    # --- attention ---
    attention: str = "causal"      # "causal" | "sliding"
    window: int = 4096             # sliding-window width
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = ()   # Qwen2-VL M-RoPE (unported)

    # --- layer pattern ---
    # cycled over layers; ported: "attn", "local_attn"
    block_pattern: Tuple[str, ...] = ("attn",)
    local_window: int = 2048       # hybrid local-attention window

    # --- modality frontend (unported: anything but "none" raises) ---
    frontend: str = "none"

    # --- numerics ---
    dtype: str = "bfloat16"        # activation dtype
    param_dtype: str = "float32"

    # --- perf variants ---
    act_seq_shard: bool = False    # sequence-parallel activations (unported)
    logits_dtype: str = "float32"  # "bfloat16" halves LM-head traffic

    # --- citation ---
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def act_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def p_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind, cycling the pattern over n_layers."""
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))

    def reduced(self, **overrides) -> "ModelConfig":
        """Reduced variant of the same family for CPU smoke tests."""
        base = dict(
            n_layers=min(self.n_layers, 2),
            d_model=min(self.d_model, 256),
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2),
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            head_dim=64,
            window=128,
            local_window=64,
        )
        base.update(overrides)
        return dataclasses.replace(self, **base)
