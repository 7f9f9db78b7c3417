"""Federated PCA over the stacked client plane (mirrors ``repro.core.pca``).

Clients share only their first and second moment sums (sum x, sum x x^T, n);
the shared basis puts every client's centroids in one space, which the
lambda_ij comparison needs.

``torch.linalg.eigh`` may return an eigenvector with the opposite sign of
``jnp.linalg.eigh``'s. Distances in the projected space, and so K-means
assignments and the lambda matrix, do not depend on those signs; parity
tests compare sign-aligned columns or the projector U U^T.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class PCA(NamedTuple):
    mean: torch.Tensor           # (d,)
    components: torch.Tensor     # (d, k) orthonormal columns
    explained_var: torch.Tensor  # (k,)

    def transform(self, x):
        return (x - self.mean) @ self.components


def _pca_from_moments(s1, s2, n, n_components: int) -> PCA:
    mean = s1 / n
    cov = s2 / n - torch.outer(mean, mean)
    evals, evecs = torch.linalg.eigh(cov)            # ascending
    idx = torch.flip(torch.argsort(evals), (0,))[:n_components]
    return PCA(mean, evecs[:, idx], evals[idx])


def fit_pca_federated_stacked(x, mask, n_components: int) -> PCA:
    """Shared basis from a mask-padded client stack.

    x: (N, cap, d) flattened client stack; mask: (N, cap) validity. The
    clients' moment sums are aggregated as one masked gemm over the stack
    (the sum of the per-client ``xm^T xm``)."""
    d = x.shape[-1]
    xm = (x * mask[..., None]).reshape(-1, d)
    s1 = mask.reshape(-1) @ x.reshape(-1, d)
    s2 = xm.T @ xm
    return _pca_from_moments(s1, s2, torch.sum(mask), n_components)
