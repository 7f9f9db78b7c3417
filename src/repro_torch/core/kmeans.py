"""K-means++ (paper Sec. III; mirrors ``repro.core.kmeans``).

Three forms, as in the reference:
  * :func:`kmeans` — one dataset, x (n, d);
  * :func:`kmeans_masked` — the valid prefix of a padded (cap, d) slice;
  * :func:`kmeans_batched` — every client of an (N, cap, d) stack. The
    reference vmaps the masked fit; here the client axis is written out, so
    each Lloyd step makes one ``ops.kmeans_assign`` call for all N clients
    (one kernel launch on the card). The unbatched forms launch once per
    Lloyd step with 2-D inputs.

The k-means++ draws are inputs (:class:`KMeansDraws`, without the client
axis for the unbatched forms): the first centroid index and one uniform per
D^2 pick. The reference picks with ``jax.random.choice(key, cap, p=probs)``,
which is ``searchsorted(cumsum(p), cumsum(p)[-1] * (1 - u))`` with one
uniform ``u``; this module does the same with the injected ``u``.
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


def kmeans_uniforms(generator: torch.Generator, n: int, k: int):
    """The size-free part of :func:`draw_kmeans`: (N,) uniforms for the
    first picks, then (N, k-1) for the D^2 picks, on the generator's
    device."""
    dev = generator.device
    return (torch.rand(n, generator=generator, device=dev),
            torch.rand((n, k - 1), generator=generator, device=dev))


def kmeans_draws_from(u_first, u, sizes) -> KMeansDraws:
    """Map :func:`kmeans_uniforms` onto clients of the given ``sizes`` on
    the sizes' device: ``first = floor(u_first * size)``. One float32
    multiply and a floor give the same indices on every device, and the
    sizes never leave theirs."""
    first = torch.floor(u_first.to(sizes.device) * sizes).long() \
        .clamp_max(sizes - 1)
    return KMeansDraws(first, u.to(sizes.device))


def draw_kmeans(generator: torch.Generator, sizes, k: int) -> KMeansDraws:
    """Draw the k-means++ picks for clients of the given ``sizes`` (a
    tensor keeps its device; other sizes go to the generator's)."""
    if not isinstance(sizes, torch.Tensor):
        sizes = torch.as_tensor(sizes, device=generator.device)
    return kmeans_draws_from(*kmeans_uniforms(generator, sizes.shape[0], k),
                             sizes)


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


# ---------------------------------------------------------------------------
# one dataset: (n, d), or the valid prefix of a padded (cap, d) slice
# ---------------------------------------------------------------------------

def kmeans_plus_plus_init_masked(x, size, k: int, draws: KMeansDraws):
    """k-means++ seeding over the valid prefix of x (cap, d); ``draws``
    without the client axis (first (), u (k-1,))."""
    return kmeans_plus_plus_init_batched(
        x[None], torch.as_tensor(size, device=x.device).reshape(1), k,
        KMeansDraws(draws.first.reshape(1), draws.u.reshape(1, -1)))[0]


def kmeans_plus_plus_init(x, k: int, draws: KMeansDraws):
    """k-means++ seeding [Arthur & Vassilvitskii 2007] over x (n, d)."""
    return kmeans_plus_plus_init_masked(x, x.shape[0], k, draws)


def lloyd_step_masked(x, valid_f, centroids):
    """One Lloyd iteration over the valid rows (``valid_f`` (cap,) {0,1})
    of x (cap, d): one 2-D ``ops.kmeans_assign`` call."""
    assign, min_d2 = kops.kmeans_assign(x, centroids)
    k = centroids.shape[0]
    onehot = torch.nn.functional.one_hot(assign.long(), k).to(x.dtype) \
        * valid_f[:, None]
    counts = torch.sum(onehot, dim=0)
    sums = onehot.T @ x
    new_c = torch.where(counts[:, None] > 0,
                        sums / torch.clamp_min(counts[:, None], 1.0),
                        centroids)
    return new_c, assign, torch.sum(torch.where(valid_f > 0, min_d2,
                                                min_d2.new_zeros(())))


def lloyd_step(x, centroids):
    return lloyd_step_masked(x, x.new_ones(x.shape[0]), centroids)


def kmeans_masked(x, size, k: int, draws: KMeansDraws,
                  n_iters: int = 25) -> KMeansResult:
    """The fit on the valid prefix of x (cap, d). Assignments past ``size``
    are meaningless."""
    valid_f = (torch.arange(x.shape[0], device=x.device) < size).to(x.dtype)
    cents = kmeans_plus_plus_init_masked(x, size, k, draws)
    cents, assign, inertia = lloyd_step_masked(x, valid_f, cents)
    for _ in range(1, n_iters):
        cents, assign, inertia = lloyd_step_masked(x, valid_f, cents)
    return KMeansResult(cents, assign, inertia)


def kmeans(x, k: int, draws: KMeansDraws, n_iters: int = 25) -> KMeansResult:
    """Full K-means++ fit of x (n, d): ``n_iters`` Lloyd steps in all."""
    return kmeans_masked(x, x.shape[0], k, draws, n_iters)


def wcss_elbow(x, k_candidates, draws) -> int:
    """Elbow method over candidate k (Assumption 2 helper). ``draws(k)``
    gives the fit's :class:`KMeansDraws` for each candidate (the reference
    seeds every candidate from one key).

    Kneedle-style: normalise (k, WCSS) to the unit square and pick the k
    with the largest vertical distance below the chord from the first to
    the last point."""
    inertias = torch.stack([kmeans(x, int(k), draws(int(k))).inertia
                            for k in k_candidates])
    if len(k_candidates) < 3:
        return int(k_candidates[int(torch.argmin(inertias))])
    ks = torch.as_tensor(k_candidates, dtype=torch.float32, device=x.device)
    kx = (ks - ks[0]) / (ks[-1] - ks[0])
    iy = (inertias - inertias[-1]) / torch.clamp_min(
        inertias[0] - inertias[-1], 1e-12)
    chord = 1.0 - kx                  # straight line from (0,1) to (1,0)
    return int(k_candidates[int(torch.argmax(chord - iy))])
