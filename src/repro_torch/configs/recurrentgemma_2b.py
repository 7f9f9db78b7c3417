"""RecurrentGemma-2B (Griffin) [arXiv:2402.19427] (mirrors
``repro.configs.recurrentgemma_2b``).

Hybrid: RG-LRU recurrent blocks + local (sliding-window) attention in a
(recurrent, recurrent, local_attn) pattern; 26 layers = 8 full groups + a
(recurrent, recurrent) remainder. MQA (kv=1), head_dim 256, window 2048.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    block_pattern=("rglru", "rglru", "local_attn"),
    rglru_d_rnn=2560,
    rglru_conv_width=4,
    local_window=2048,
    long_context_mode="recurrent_state",
    source="arXiv:2402.19427",
)


def smoke_config() -> ModelConfig:
    return CONFIG.reduced(n_heads=2, n_kv_heads=1, head_dim=64)
