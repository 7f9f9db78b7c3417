"""Phi-3.5-MoE 42B (6.6B active) [hf:microsoft/Phi-3.5-MoE-instruct]
(mirrors ``repro.configs.phi35_moe_42b``).

16 experts, top-2 routing, GQA kv=8.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,          # per-expert hidden size
    vocab_size=32064,
    n_experts=16,
    experts_per_token=2,
    n_shared_experts=0,
    moe_d_ff=6400,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)


def smoke_config() -> ModelConfig:
    return CONFIG.reduced()
