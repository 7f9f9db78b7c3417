"""MusicGen-medium [arXiv:2306.05284] (mirrors
``repro.configs.musicgen_medium``).

Decoder-only transformer over EnCodec tokens: 4 codebooks, vocab 2048 each.
The EnCodec codec itself is the stubbed modality frontend: the backbone
consumes codebook token ids, their embeddings are summed across codebooks
and one head of width 4 x 2048 predicts the next code of every book.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    head_dim=64,
    frontend="audio_codec",
    n_codebooks=4,
    source="arXiv:2306.05284",
)


def smoke_config() -> ModelConfig:
    return CONFIG.reduced(n_codebooks=2)
