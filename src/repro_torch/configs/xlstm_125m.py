"""xLSTM-125M [arXiv:2405.04517] (mirrors ``repro.configs.xlstm_125m``).

Alternating sLSTM (true scalar-memory recurrence) and mLSTM (matrix memory,
chunkwise-parallel) blocks. d_ff=0: xLSTM blocks carry their own
up-projections (proj factor 2 for mLSTM; sLSTM post-FFN 4/3).
Attention-free: decode carries O(1) recurrent state.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=192,
    block_pattern=("mlstm", "slstm"),
    xlstm_proj_factor=2.0,
    long_context_mode="recurrent_state",
    source="arXiv:2405.04517",
)


def smoke_config() -> ModelConfig:
    return CONFIG.reduced(n_heads=2, n_kv_heads=2, head_dim=64, d_model=128)
