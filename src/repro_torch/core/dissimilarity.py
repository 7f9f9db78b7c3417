"""Cross-client dataset dissimilarity lambda_ij (paper Sec. III; mirrors the
stacked form of ``repro.core.dissimilarity``).

  lambda_ij_m = #{ n : ||v_in - v_jm|| > beta }
  lambda_ij   = sum_m 1[lambda_ij_m == k_i] * T_j[i, m]

the number of c_j's clusters that are far from every c_i cluster and that c_j
trusts c_i with.
"""
from __future__ import annotations

import torch


def lambda_matrix(cents, trust, beta):
    """cents (N, k, d), trust (N_tx, N_rx, k) -> (N, N) int32 lambda[i, j]
    (diagonal 0)."""
    d = torch.linalg.norm(
        cents[:, None, :, None, :] - cents[None, :, None, :, :], dim=-1)
    far = (d > beta).all(dim=2)                          # (N, N, k_j)
    trust_rx = trust.transpose(0, 1)                     # [i, j, m] = T_j[i, m]
    lam = torch.sum(far.to(torch.int32) * trust_rx.to(torch.int32), dim=-1,
                    dtype=torch.int32)
    n = lam.shape[0]
    return lam * (1 - torch.eye(n, dtype=torch.int32, device=lam.device))


def median_heuristic_beta(cents, scale: float = 1.0):
    """The median of all cross-centroid distances, scaled (a device scalar).

    For an even count it is the midpoint of the two middle values, as
    ``jnp.median`` computes it."""
    c = cents.reshape(-1, cents.shape[-1])
    d = torch.linalg.norm(c[:, None] - c[None, :], dim=-1)
    iu = torch.triu_indices(d.shape[0], d.shape[0], 1, device=d.device)
    v = torch.sort(d[iu[0], iu[1]]).values
    m = v.shape[0]
    return (v[(m - 1) // 2] + v[m // 2]) * 0.5 * scale
