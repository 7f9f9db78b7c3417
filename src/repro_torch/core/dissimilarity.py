"""Cross-client dataset dissimilarity lambda_ij (paper Sec. III; mirrors the
stacked form of ``repro.core.dissimilarity``).

  lambda_ij_m = #{ n : ||v_in - v_jm|| > beta }
  lambda_ij   = sum_m 1[lambda_ij_m == k_i] * T_j[i, m]

the number of c_j's clusters that are far from every c_i cluster and that c_j
trusts c_i with.

Both entry points take the stacked form ((N, k, d) centroids, (N_tx, N_rx,
k) trust) or the reference's ragged lists (per-client (k_i, d) centroids,
per-transmitter (N, k_j) trust matrices); the stacked form computes every
pair in one broadcast, equal to the pairwise loop.
"""
from __future__ import annotations

import torch


def lambda_pair(cents_i, cents_j, trust_col, beta):
    """cents_i (k_i, d), cents_j (k_j, d), trust_col (k_j,) in {0, 1} ->
    lambda_ij as an int32 scalar."""
    d = torch.linalg.norm(cents_i[:, None, :] - cents_j[None, :, :], dim=-1)
    far = (d > beta).all(dim=0)                          # (k_j,)
    return torch.sum(far.to(torch.int32) * trust_col.to(torch.int32),
                     dtype=torch.int32)


def stack_trust(trust) -> torch.Tensor:
    """A list of T_j (N, k) -> (N_tx, N_rx, k) with [j, i, m] = T_j[i, m];
    a stacked tensor passes through. Needs one cluster count: ragged k_j
    worlds use the list form of :func:`lambda_matrix`."""
    if not isinstance(trust, (list, tuple)):
        return torch.as_tensor(trust)
    k = trust[0].shape[1]
    if any(t.shape[1] != k for t in trust):
        raise ValueError("stack_trust needs a uniform cluster count; got "
                         f"{[t.shape[1] for t in trust]}")
    return torch.stack([torch.as_tensor(t) for t in trust])


def lambda_matrix(cents, trust, beta):
    """cents (N, k, d) and trust (N_tx, N_rx, k) (or a uniform-k list), or
    the ragged lists -> (N, N) int32 lambda[i, j] (diagonal 0)."""
    if isinstance(cents, (list, tuple)):
        n = len(cents)
        zero = torch.zeros((), dtype=torch.int32, device=cents[0].device)
        return torch.stack([torch.stack([
            zero if i == j else lambda_pair(cents[i], cents[j],
                                            torch.as_tensor(trust[j])[i],
                                            beta)
            for j in range(n)]) for i in range(n)])
    return lambda_matrix_stacked(cents, trust, beta)


def lambda_matrix_stacked(cents, trust, beta):
    """Stacked-form lambda: cents (N, k, d), trust (N_tx, N_rx, k) or a
    uniform-k list -> (N, N) int32 (diagonal 0)."""
    trust = stack_trust(trust)
    d = torch.linalg.norm(
        cents[:, None, :, None, :] - cents[None, :, None, :, :], dim=-1)
    far = (d > beta).all(dim=2)                          # (N, N, k_j)
    trust_rx = trust.transpose(0, 1)                     # [i, j, m] = T_j[i, m]
    lam = torch.sum(far.to(torch.int32) * trust_rx.to(torch.int32), dim=-1,
                    dtype=torch.int32)
    n = lam.shape[0]
    return lam * (1 - torch.eye(n, dtype=torch.int32, device=lam.device))


def median_heuristic_beta(cents, scale: float = 1.0):
    """The median of all cross-centroid distances, scaled (a device scalar),
    from the stacked (N, k, d) centroids or the ragged list.

    For an even count it is the midpoint of the two middle values, as
    ``jnp.median`` computes it."""
    c = torch.cat(list(cents)) if isinstance(cents, (list, tuple)) else \
        cents.reshape(-1, cents.shape[-1])
    d = torch.linalg.norm(c[:, None] - c[None, :], dim=-1)
    iu = torch.triu_indices(d.shape[0], d.shape[0], 1, device=d.device)
    v = torch.sort(d[iu[0], iu[1]]).values
    m = v.shape[0]
    return (v[(m - 1) // 2] + v[m // 2]) * 0.5 * scale
