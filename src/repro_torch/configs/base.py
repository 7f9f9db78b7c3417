"""Architecture, input-shape and training configuration dataclasses (the
port's own copy of ``repro.configs.base``; ``act_dtype`` and ``p_dtype``
give torch dtypes).

Every ported architecture gets a ``configs/<id>.py`` exporting ``CONFIG``
(the exact full-size config) and ``smoke_config()`` (the reduced variant used
by CPU tests: <= 2 layers, d_model <= 512).

Holds the fields the ported families read: the dense transformer, MoE,
xLSTM, the RG-LRU hybrid, the vision stub (``frontend="vision_stub"``,
``frontend_dim``, M-RoPE's ``mrope_sections``) and the audio codec frontend
(``frontend="audio_codec"``, ``n_codebooks``). ``act_seq_shard`` splits the
activations between units along S over the model axis of the model plane
(``models.transformer``); without a model axis above one rank it changes
nothing. ``scan_unroll`` (a lowering switch of the JAX
package's roofline pass) has no counterpart here.
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

    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0          # per-expert hidden size (routed experts)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_group_size: int = 0        # tokens per dispatch group (0: one batch
                                   # row per group, the GShard default)
    moe_dispatch: str = "einsum"   # "einsum" (one-hot (T,E,C)) | "gather"
                                   # (sort and index dispatch)

    # --- attention ---
    attention: str = "causal"      # "causal" | "sliding"
    window: int = 4096             # sliding-window width
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = ()   # Qwen2-VL M-RoPE (t, h, w) splits
    long_context_mode: str = "sliding_window"  # how long_500k is served

    # --- layer pattern (ssm / hybrid) ---
    # cycled over layers; entries: "attn", "local_attn", "mlstm", "slstm", "rglru"
    block_pattern: Tuple[str, ...] = ("attn",)
    rglru_conv_width: int = 4
    rglru_d_rnn: int = 0           # 0 -> d_model
    local_window: int = 2048       # hybrid local-attention window
    xlstm_proj_factor: float = 2.0  # mLSTM up-projection
    xlstm_conv_width: int = 4

    # --- modality frontend (stubbed, as in the JAX package) ---
    frontend: str = "none"         # "none" | "vision_stub" | "audio_codec"
    frontend_dim: int = 0          # stub embedding dim (vision patches)
    n_codebooks: int = 0           # musicgen EnCodec codebooks

    # --- numerics ---
    dtype: str = "bfloat16"        # activation dtype
    param_dtype: str = "float32"

    # --- perf variants ---
    act_seq_shard: bool = False    # sequence-parallel activations
    logits_dtype: str = "float32"  # "bfloat16" halves LM-head traffic

    # --- citation ---
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.rglru_d_rnn == 0:
            object.__setattr__(self, "rglru_d_rnn", self.d_model)

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
            frontend_dim=min(self.frontend_dim, 128) if self.frontend_dim else 0,
        )
        if self.is_moe:
            base.update(
                n_experts=min(self.n_experts, 4),
                experts_per_token=min(self.experts_per_token, 2),
                n_shared_experts=min(self.n_shared_experts, 1),
                moe_d_ff=min(self.moe_d_ff, 256),
            )
        if self.family == "hybrid":
            base.update(rglru_d_rnn=min(self.rglru_d_rnn, 256))
        base.update(overrides)
        return dataclasses.replace(self, **base)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer / schedule / runtime knobs for the generic trainer."""
    optimizer: str = "adamw"
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1_000
    remat: str = "block"   # "none" | "block" -- activation checkpoint policy
    seed: int = 0
