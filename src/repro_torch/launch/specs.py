"""Stand-ins for every step's inputs (mirrors ``repro.launch.specs``).

``input_specs(cfg, shape)`` returns the batch a step of ``shape`` takes as
tensors on the ``meta`` device: the reference's shapes and dtypes, no
memory. For VLM/audio the modality frontend is stubbed, as in the JAX
package: the batch carries patch embeddings / codec token ids of the right
shape. :func:`input_specs_logical` returns the reference's pair, the batch
and each input's logical sharding axes.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import sharding as sh
from repro_torch.configs.base import InputShape, ModelConfig

VLM_IMG_TOKENS = 256  # patch tokens prepended by the stubbed vision frontend


def shape_config(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Shape-specialised config: long_500k decode on a full-attention arch
    switches to its documented sliding-window long-context mode."""
    if (shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid")
            and cfg.attention != "sliding"):
        assert cfg.long_context_mode == "sliding_window", cfg.name
        return dataclasses.replace(cfg, attention="sliding")
    return cfg


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def train_input_specs(cfg: ModelConfig, b: int, s: int) -> dict:
    i32 = torch.int32
    if cfg.frontend == "audio_codec":
        return {"codes": _meta((b, s, cfg.n_codebooks), i32),
                "labels": _meta((b, s, cfg.n_codebooks), i32)}
    if cfg.frontend == "vision_stub":
        n_img = min(VLM_IMG_TOKENS, s // 2)
        return {"embeds": _meta((b, n_img, cfg.frontend_dim), torch.bfloat16),
                "tokens": _meta((b, s - n_img), i32),
                "labels": _meta((b, s), i32)}
    return {"tokens": _meta((b, s), i32), "labels": _meta((b, s), i32)}


def prefill_input_specs(cfg: ModelConfig, b: int, s: int) -> dict:
    specs = train_input_specs(cfg, b, s)
    specs.pop("labels")
    return specs


def decode_input_specs(cfg: ModelConfig, b: int) -> dict:
    if cfg.frontend == "audio_codec":
        return {"codes": _meta((b, 1, cfg.n_codebooks), torch.int32)}
    return {"token": _meta((b, 1), torch.int32)}


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """The batch of the step the shape exercises, on the meta device."""
    if shape.kind == "train":
        return train_input_specs(cfg, shape.global_batch, shape.seq_len)
    if shape.kind == "prefill":
        return prefill_input_specs(cfg, shape.global_batch, shape.seq_len)
    return decode_input_specs(cfg, shape.global_batch)


def input_specs_logical(cfg: ModelConfig, shape: InputShape):
    """(specs, logical), as the reference's ``input_specs`` returns: each
    input's logical axes put its batch axis over BATCH and replicate every
    other axis."""
    specs = input_specs(cfg, shape)
    return specs, {k: (sh.BATCH,) + (None,) * (v.dim() - 1)
                   for k, v in specs.items()}
