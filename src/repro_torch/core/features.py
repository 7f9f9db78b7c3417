"""Unsupervised feature extractors feeding PCA + K-means (mirrors
``repro.core.features``).

Token architectures have no pixels, so the unlabeled representation is each
sequence's mean-pooled embedding under a frozen random table: this lets the
graph-discovery pipeline drive D2D exchange for LLM federated training
(``repro_torch.examples.federated_llm``)."""
from __future__ import annotations

import math

import torch


def token_sequence_features(tokens, embed_table):
    """tokens: (n, S) int; embed_table: (V, D) -> (n, D) mean-pooled."""
    return torch.mean(embed_table[tokens.long()], dim=1)


def draw_embed_normals(generator: torch.Generator, vocab: int,
                       dim: int = 64) -> torch.Tensor:
    """The (vocab, dim) standard normals of :func:`random_embed_table`."""
    return torch.randn((vocab, dim), generator=generator,
                       device=generator.device)


def random_embed_table(normals):
    """Frozen random features from (vocab, dim) standard normals, scaled by
    1 / sqrt(dim); every client derives them from the same public seed."""
    return normals / math.sqrt(normals.shape[-1])


def image_features(images):
    """Flatten images (the paper's raw-pixel features before PCA)."""
    return images.reshape(images.shape[0], -1)
