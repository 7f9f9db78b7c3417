"""Stand-ins for every step's inputs (mirrors ``repro.launch.specs``).

``input_specs(cfg, shape)`` returns the batch a step of ``shape`` takes as
tensors on the ``meta`` device: the reference's shapes and dtypes, no
memory; with ``rules``, one rank's rows of it (the batch split over the
data axes when it divides them, as ``rules.spec`` places BATCH;
:func:`place_batch`). For VLM/audio the modality frontend is stubbed, as
in the JAX package: the batch carries patch embeddings / codec token ids
of the right shape. :func:`input_specs_logical` returns the reference's pair, the batch
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


def input_specs(cfg: ModelConfig, shape: InputShape, rules=None) -> dict:
    """The batch of the step the shape exercises, on the meta device: one
    rank's rows under ``rules``."""
    if shape.kind == "train":
        specs = train_input_specs(cfg, shape.global_batch, shape.seq_len)
    elif shape.kind == "prefill":
        specs = prefill_input_specs(cfg, shape.global_batch, shape.seq_len)
    else:
        specs = decode_input_specs(cfg, shape.global_batch)
    return place_batch(specs, rules)


def batch_logical(batch: dict) -> dict:
    """Each input's logical axes: its batch axis over BATCH, every other
    axis replicated."""
    return {k: (sh.BATCH,) + (None,) * (v.dim() - 1) for k, v in batch.items()}


def place_batch(batch: dict, rules) -> dict:
    """This rank's rows of a whole batch (``sharding.place_params``); the
    identity at ``rules=None``."""
    return sh.place_params(batch, batch_logical(batch), rules)


def input_specs_logical(cfg: ModelConfig, shape: InputShape):
    """(specs, logical), as the reference's ``input_specs`` returns: each
    input's logical axes put its batch axis over BATCH and replicate every
    other axis."""
    specs = input_specs(cfg, shape)
    return specs, batch_logical(specs)
