"""Batched, masked K-means++ over the client stack (mirrors
``repro.core.kmeans``).

The reference vmaps one client's fit over N clients; here the client axis is
written out, so each Lloyd step makes one ``ops.kmeans_assign`` call for all
N clients (one kernel launch on the card).

The k-means++ draws are inputs (:class:`KMeansDraws`): per client, the first
centroid index and one uniform per D^2 pick. The reference picks with
``jax.random.choice(key, cap, p=probs)``, which is
``searchsorted(cumsum(p), cumsum(p)[-1] * (1 - u))`` with one uniform ``u``;
this module does the same with the injected ``u``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops as kops


class KMeansResult(NamedTuple):
    centroids: torch.Tensor    # (N, k, d)
    assignments: torch.Tensor  # (N, cap) int32
    inertia: torch.Tensor      # (N,) sum of squared distances to centroids


class KMeansDraws(NamedTuple):
    first: torch.Tensor   # (N,) int64 first centroid index, in [0, size_i)
    u: torch.Tensor       # (N, k-1) uniforms for the D^2 picks


def draw_kmeans(generator: torch.Generator, sizes, k: int) -> KMeansDraws:
    """Draw the k-means++ picks for clients of the given ``sizes``."""
    dev = generator.device
    sizes = torch.as_tensor(sizes, device=dev)
    n = sizes.shape[0]
    first = torch.floor(torch.rand(n, generator=generator, device=dev)
                        * sizes).long().clamp_max(sizes - 1)
    return KMeansDraws(first, torch.rand((n, k - 1), generator=generator,
                                         device=dev))


def _sq_dist(x, c):
    """x (N, cap, d), c (N, d) -> (N, cap) squared distances."""
    return torch.sum(torch.square(x - c[:, None, :]), dim=-1)


def kmeans_plus_plus_init_batched(x, sizes, k: int, draws: KMeansDraws):
    """k-means++ seeding over each client's valid prefix of x (N, cap, d)."""
    n, cap, _ = x.shape
    rows = torch.arange(n, device=x.device)
    valid = torch.arange(cap, device=x.device)[None, :] < sizes[:, None]
    zero = x.new_zeros(())
    cents = x.new_zeros((n, k, x.shape[2]))
    cents[:, 0] = x[rows, draws.first]
    d2 = torch.where(valid, _sq_dist(x, cents[:, 0]), zero)
    for i in range(1, k):
        probs = d2 / torch.clamp_min(torch.sum(d2, dim=1, keepdim=True),
                                     1e-12)
        cum = torch.cumsum(probs, dim=1)
        r = cum[:, -1:] * (1.0 - draws.u[:, i - 1:i])
        idx = torch.searchsorted(cum, r).clamp_max(cap - 1)[:, 0]
        cents[:, i] = x[rows, idx]
        d2 = torch.minimum(d2, torch.where(valid, _sq_dist(x, cents[:, i]),
                                           zero))
    return cents


def lloyd_step_batched(x, valid_f, centroids):
    """One Lloyd iteration for every client. valid_f: (N, cap) {0,1}."""
    assign, min_d2 = kops.kmeans_assign(x, centroids)
    k = centroids.shape[1]
    onehot = torch.nn.functional.one_hot(assign.long(), k).to(x.dtype) \
        * valid_f[..., None]                              # (N, cap, k)
    counts = torch.sum(onehot, dim=1)                     # (N, k)
    sums = onehot.transpose(1, 2) @ x                     # (N, k, d)
    new_c = torch.where(counts[..., None] > 0,
                        sums / torch.clamp_min(counts[..., None], 1.0),
                        centroids)
    inertia = torch.sum(torch.where(valid_f > 0, min_d2,
                                    min_d2.new_zeros(())), dim=1)
    return new_c, assign, inertia


def kmeans_batched(x, sizes, k: int, draws: KMeansDraws,
                   n_iters: int = 25) -> KMeansResult:
    """All clients' K-means++ fits. x: (N, cap, d); sizes: (N,).

    ``n_iters`` Lloyd steps in all (the reference's initial step plus its
    ``n_iters - 1`` loop iterations). Assignments at index >= sizes[i] are
    meaningless."""
    sizes = torch.as_tensor(sizes, device=x.device)
    valid_f = (torch.arange(x.shape[1], device=x.device)[None, :]
               < sizes[:, None]).to(x.dtype)
    cents = kmeans_plus_plus_init_batched(x, sizes, k, draws)
    cents, assign, inertia = lloyd_step_batched(x, valid_f, cents)
    for _ in range(1, n_iters):
        cents, assign, inertia = lloyd_step_batched(x, valid_f, cents)
    return KMeansResult(cents, assign, inertia)
