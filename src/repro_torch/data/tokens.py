"""Synthetic token streams with client-level topic skew (mirrors
``repro.data.tokens``).

Each client has "topics": preferred slices of the vocabulary. A token is
drawn from its topic's slice with probability ``p_topic`` and from the whole
vocabulary otherwise, so PCA + K-means on mean-pooled embeddings can tell
clients apart (``core.features``).

The draws are inputs (:class:`TopicDraws`): the topical ids (already inside
their topic's slice), the global ids and one uniform per token. The
``draw_*`` helpers draw them from a generator.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class TopicDraws(NamedTuple):
    topical: torch.Tensor   # (..., batch, seq_len) ids inside the topic slice
    glob: torch.Tensor      # (..., batch, seq_len) ids in [0, vocab)
    u: torch.Tensor         # (..., batch, seq_len) uniforms in [0, 1)


def draw_topic_tokens(generator: torch.Generator, topics, *, batch: int,
                      seq_len: int, vocab: int,
                      n_topics: int = 8) -> TopicDraws:
    """Draws for one (batch, seq_len) block per entry of ``topics`` (a
    tensor of topic indices of any shape, which leads the draws' shape)."""
    dev = generator.device
    topics = torch.as_tensor(topics, device=dev)
    slice_size = vocab // n_topics
    shape = tuple(topics.shape) + (batch, seq_len)
    lo = (topics * slice_size).reshape(tuple(topics.shape) + (1, 1))
    topical = lo + torch.randint(0, slice_size, shape, generator=generator,
                                 device=dev)
    glob = torch.randint(0, vocab, shape, generator=generator, device=dev)
    return TopicDraws(topical, glob,
                      torch.rand(shape, generator=generator, device=dev))


def topic_token_batch(draws: TopicDraws, p_topic: float = 0.85):
    """int32 tokens: the topical id where u < p_topic, else the global id."""
    return torch.where(draws.u < p_topic, draws.topical,
                       draws.glob).to(torch.int32)


def client_domains(n_clients: int, n_topics: int = 8,
                   topics_per_client: int = 2) -> list:
    """Client i's topics: i, i + 1, ... (mod n_topics)."""
    return [[(i + t) % n_topics for t in range(topics_per_client)]
            for i in range(n_clients)]


def draw_client_tokens(generator: torch.Generator, *, n_clients: int,
                       n_seqs: int, seq_len: int, vocab: int,
                       n_topics: int = 8,
                       topics_per_client: int = 2) -> TopicDraws:
    """Draws of shape (n_clients, topics_per_client, n_seqs //
    topics_per_client, seq_len) for :func:`make_client_token_data`."""
    return draw_topic_tokens(
        generator, client_domains(n_clients, n_topics, topics_per_client),
        batch=n_seqs // topics_per_client, seq_len=seq_len, vocab=vocab,
        n_topics=n_topics)


def make_client_token_data(draws: TopicDraws, *, n_topics: int = 8,
                           p_topic: float = 0.85):
    """Per-client token datasets from draws of shape (n_clients,
    topics_per_client, per_topic, seq_len): a list of (topics_per_client *
    per_topic, seq_len) int32 tensors, the client's topics in order, and the
    domain list."""
    n_clients, tpc, per, s = draws.u.shape
    tokens = topic_token_batch(draws, p_topic).reshape(n_clients, tpc * per, s)
    return list(tokens.unbind(0)), client_domains(n_clients, n_topics, tpc)
