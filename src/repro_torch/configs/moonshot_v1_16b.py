"""Moonlight-16B-A3B [hf:moonshotai/Moonlight-16B-A3B] (mirrors
``repro.configs.moonshot_v1_16b``).

DeepSeek-V3-style MoE: 64 routed experts top-6 + 2 shared experts,
per-expert hidden 1408. (The real model's first layer is dense d_ff=11264;
the JAX package keeps all layers MoE for a homogeneous layer stack, and
so does the port.)
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    head_dim=128,
    n_experts=64,
    experts_per_token=6,
    n_shared_experts=2,
    moe_d_ff=1408,
    source="hf:moonshotai/Moonlight-16B-A3B",
)


def smoke_config() -> ModelConfig:
    return CONFIG.reduced()
