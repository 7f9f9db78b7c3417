"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B] (mirrors
``repro.configs.qwen2_moe_a27b``).

60 routed experts top-4 + 4 shared experts, per-expert hidden 1408.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    head_dim=128,
    n_experts=60,
    experts_per_token=4,
    n_shared_experts=4,
    moe_d_ff=1408,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)


def smoke_config() -> ModelConfig:
    return CONFIG.reduced()
