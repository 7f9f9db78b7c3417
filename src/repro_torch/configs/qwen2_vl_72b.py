"""Qwen2-VL-72B language backbone [arXiv:2409.12191] (mirrors
``repro.configs.qwen2_vl_72b``).

VLM: the ViT vision encoder is a stub, as in the JAX package: the prefill
batch carries precomputed patch embeddings (frontend_dim) that a linear
projector maps into d_model, ahead of the text tokens. M-RoPE (t/h/w
sections) on the backbone.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),   # t/h/w splits of head_dim//2 = 64
    frontend="vision_stub",
    frontend_dim=1280,             # ViT output width fed to the projector
    source="arXiv:2409.12191",
)


def smoke_config() -> ModelConfig:
    return CONFIG.reduced(mrope_sections=(8, 12, 12))
