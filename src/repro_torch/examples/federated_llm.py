"""The paper's technique on an LLM (mirrors ``examples/federated_llm.py``).

    PYTHONPATH=src python -m repro_torch.examples.federated_llm \
        [--arch llama3.2-1b] [--device cpu]

Six clients hold topic-skewed token data (the LLM analogue of non-i.i.d.
class skew). The core pipeline drives a D2D exchange: features are
mean-pooled frozen-random embeddings (``core.features``); PCA, K-means++,
lambda, rewards and RL discovery are the image case's. Then each client
trains the reduced LLM locally with FedAvg every ``tau_a`` steps, and the
held-out perplexity with the exchange is compared with the one without.

Every client holds the same number of sequences and the same k, so the
stacked forms (``fit_pca_federated_stacked``, ``kmeans_batched``: one
``kmeans_assign`` launch per Lloyd step for all clients) compute what the
reference's per-client lists compute. Every draw is an input, with a
generator convenience.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch import optim, resolve_device
from repro_torch.configs import ARCH_IDS, TrainConfig, get_smoke_config
from repro_torch.core import channel as ch
from repro_torch.core import dissimilarity as dis
from repro_torch.core import features as feat
from repro_torch.core import kmeans as km
from repro_torch.core import pca as pca_lib
from repro_torch.core import qlearning as ql
from repro_torch.core import rewards as rw
from repro_torch.core import trust as tr
from repro_torch.core.pipeline import move_draws
from repro_torch.data.tokens import (draw_client_tokens, draw_topic_tokens,
                                     make_client_token_data,
                                     topic_token_batch)
from repro_torch.models.common import tree_map
from repro_torch.models.registry import build_model, make_train_step

N_CLIENTS = 6
N_SEQS = 64
SEQ = 64
TOPICS_PER_CLIENT = 2
EMBED_DIM = 64
N_PCA = 16
K = 2
RL = ql.RLConfig(n_episodes=300, buffer_size=50)


class DiscoveryDraws(NamedTuple):
    embed: torch.Tensor          # (vocab, EMBED_DIM) normals of the table
    kmeans: km.KMeansDraws       # k-means++ picks, per client
    trust_u: torch.Tensor        # (N, N, K) trust uniforms
    positions: torch.Tensor      # (N, 2) device positions
    fading: torch.Tensor         # (N, N) fading draw
    rl: ql.RLDraws               # the mixed policy's per-episode draws


def draw_discovery(generator: torch.Generator, vocab: int) -> DiscoveryDraws:
    return DiscoveryDraws(
        feat.draw_embed_normals(generator, vocab, EMBED_DIM),
        km.draw_kmeans(generator, [N_SEQS] * N_CLIENTS, K),
        tr.draw_trust_uniforms(generator, N_CLIENTS, K),
        ch.make_positions(generator, N_CLIENTS),
        ch.init_fading(generator, N_CLIENTS),
        ql.draw_rl(generator, N_CLIENTS, RL.n_episodes))


class Discovery(NamedTuple):
    datasets: list               # per client, after the exchange
    graph: ql.GraphResult
    lam: torch.Tensor            # (N, N) int32
    centroids: torch.Tensor      # (N, K, N_PCA)
    assignments: torch.Tensor    # (N, N_SEQS) int32
    moved: torch.Tensor          # (N,) sequences each receiver got


def discover_and_exchange(datasets, vocab: int, *,
                          draws: Optional[DiscoveryDraws] = None,
                          generator: Optional[torch.Generator] = None
                          ) -> Discovery:
    """Paper Alg. 1 on token data, then a sequence-level exchange: each
    receiver i takes up to a quarter of its transmitter j's sequences from
    j's cluster farthest from the mean of i's centroids, if j trusts i with
    any cluster. ``datasets``: N (N_SEQS, SEQ) token tensors on one device;
    ``draws`` (or ``generator`` draws them) move to that device."""
    dev = datasets[0].device
    if draws is None:
        draws = draw_discovery(generator, vocab)
    draws = move_draws(draws, dev)
    table = feat.random_embed_table(draws.embed)
    flats = torch.stack([feat.token_sequence_features(d, table)
                         for d in datasets])                 # (N, n, 64)
    n, rows = flats.shape[:2]
    pca = pca_lib.fit_pca_federated_stacked(
        flats, torch.ones((n, rows), device=dev), N_PCA)
    res = km.kmeans_batched(pca.transform(flats), [rows] * n, K, draws.kmeans)
    cents, assigns = res.centroids, res.assignments
    trust = tr.make_trust(draws.trust_u, 0.95)
    pf = ch.failure_prob(ch.rss_from_state(draws.positions, draws.fading))
    beta = dis.median_heuristic_beta(cents, 0.8)
    lam = dis.lambda_matrix(cents, trust, beta)
    graph = ql.discover_graph(rw.local_reward_matrix(lam, pf), pf, RL,
                              draws=draws.rl)

    j = graph.in_edge                                        # (N,)
    far = torch.argmax(torch.linalg.norm(
        cents[j] - cents.mean(dim=1)[:, None], dim=-1), dim=1)
    take = assigns[j] == far[:, None]                        # (N, n)
    take &= torch.cumsum(take.to(torch.int32), dim=1) <= rows // 4
    idx = torch.arange(n, device=dev)
    take &= (trust[j, idx].amax(dim=-1) > 0)[:, None]
    new = [torch.cat([datasets[i], datasets[int(j[i])][take[i]]])
           for i in range(n)]
    return Discovery(new, graph, lam, cents, assigns,
                     take.sum(dim=1))


def draw_batch_indices(generator: torch.Generator, sizes, steps: int,
                       batch: int) -> torch.Tensor:
    """(steps, N, batch) minibatch rows, uniform over each client's size."""
    u = torch.rand((steps, len(sizes), batch), generator=generator,
                   device=generator.device)
    sizes = torch.as_tensor(sizes, device=u.device)[None, :, None]
    return torch.minimum((u * sizes).long(), sizes - 1)


def fed_train_llm(model, datasets, *, steps: int = 30, tau_a: int = 5,
                  batch: int = 4, init_params=None, batch_idx=None,
                  generator: Optional[torch.Generator] = None):
    """FedAvg over the clients: every client takes one AdamW step per
    iteration from its own state; every ``tau_a`` steps the clients'
    parameters are averaged and broadcast (the optimizer states stay
    local). ``init_params`` and ``batch_idx`` (steps, N, batch) are drawn
    from ``generator`` when not given. Returns the global parameters."""
    dev = datasets[0].device
    tc = TrainConfig(optimizer="adamw", learning_rate=1e-3, total_steps=steps,
                     warmup_steps=5)
    step_fn = make_train_step(model, tc)
    if init_params is None:
        init_params = model.init(generator, device=dev)
    if batch_idx is None:
        batch_idx = draw_batch_indices(
            generator, [d.shape[0] for d in datasets], steps, batch)
    batch_idx = batch_idx.to(dev)
    g_params = init_params
    # one tree shared by every client, as in the reference: the updates
    # return new tensors and never write into it
    params = [g_params] * len(datasets)
    opts = [optim.init_opt_state(g_params, tc.optimizer)] * len(datasets)
    for t in range(steps):
        for i, data in enumerate(datasets):
            toks = data[batch_idx[t, i]]
            params[i], opts[i], _ = step_fn(params[i], opts[i],
                                            {"tokens": toks, "labels": toks})
        if (t + 1) % tau_a == 0:   # FedAvg aggregation + broadcast
            g_params = tree_map(lambda *ps: sum(ps) / len(ps), *params)
            params = [g_params] * len(datasets)
    return g_params


def draw_heldout(generator: torch.Generator, vocab: int):
    """Draws of the held-out mix: 4 sequences of each of the 8 topics."""
    return draw_topic_tokens(generator, list(range(8)), batch=4, seq_len=SEQ,
                             vocab=vocab)


def eval_ppl(model, params, tokens) -> float:
    """exp of the mean next-token CE on ``tokens`` (n, SEQ)."""
    with torch.no_grad():
        loss, _ = model.loss_fn(params, {"tokens": tokens, "labels": tokens})
    return float(torch.exp(loss))


@dataclasses.dataclass
class FedLLMResult:
    domains: list
    discovery: Discovery
    ppl_base: float
    ppl_smart: float


def main(argv=None) -> FedLLMResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=list(ARCH_IDS))
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    cfg = get_smoke_config(args.arch)
    model = build_model(cfg)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    print(f"== {N_CLIENTS} clients with topic-skewed token data "
          f"(arch={cfg.name}, reduced)")
    datasets, domains = make_client_token_data(draw_client_tokens(
        gen, n_clients=N_CLIENTS, n_seqs=N_SEQS, seq_len=SEQ,
        vocab=cfg.vocab_size, topics_per_client=TOPICS_PER_CLIENT))
    print("   topic domains:", domains)

    print("== RL graph discovery + sequence exchange (paper Alg. 1)")
    disc = discover_and_exchange(datasets, cfg.vocab_size, generator=gen)
    print("   lambda matrix:\n", disc.lam.cpu().numpy())
    print("   links (rx <- tx):",
          list(enumerate(disc.graph.in_edge.tolist())))
    print("   moved sequences:", disc.moved.tolist())

    print(f"== federated training ({args.steps} steps, tau_a=5)")
    # both runs start from the same parameters and batch draws
    p_base = fed_train_llm(model, datasets, steps=args.steps,
                           generator=torch.Generator(device=dev).manual_seed(
                               args.seed + 3))
    p_smart = fed_train_llm(model, disc.datasets, steps=args.steps,
                            generator=torch.Generator(device=dev).manual_seed(
                                args.seed + 3))
    heldout = topic_token_batch(draw_heldout(gen, cfg.vocab_size)).reshape(
        -1, SEQ)
    ppl_base = eval_ppl(model, p_base, heldout)
    ppl_smart = eval_ppl(model, p_smart, heldout)
    print(f"== held-out (all-topic) perplexity: "
          f"non-iid={ppl_base:.2f}  smart-D2D={ppl_smart:.2f}")
    return FedLLMResult(domains, disc, ppl_base, ppl_smart)


if __name__ == "__main__":
    main()
