"""Federated PCA over the stacked client plane (mirrors ``repro.core.pca``).

Clients share only their first and second moment sums (sum x, sum x x^T, n);
the shared basis puts every client's centroids in one space, which the
lambda_ij comparison needs. :func:`fit_pca` fits one dataset,
:func:`fit_pca_federated` a list of client arrays, and
:func:`fit_pca_federated_stacked` the mask-padded client stack, the
pipeline's path; sharded over the clients, its one collective is the
all-reduce of the moments.

``torch.linalg.eigh`` may return an eigenvector with the opposite sign of
``jnp.linalg.eigh``'s. Distances in the projected space, and so K-means
assignments and the lambda matrix, do not depend on those signs; parity
tests compare sign-aligned columns or the projector U U^T.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from repro_torch import sharding as sh


class PCA(NamedTuple):
    mean: torch.Tensor           # (d,)
    components: torch.Tensor     # (d, k) orthonormal columns
    explained_var: torch.Tensor  # (k,)

    def transform(self, x):
        return (x - self.mean) @ self.components

    def inverse(self, z):
        return z @ self.components.T + self.mean


def _pca_from_moments(s1, s2, n, n_components: int) -> PCA:
    mean = s1 / n
    cov = s2 / n - torch.outer(mean, mean)
    evals, evecs = torch.linalg.eigh(cov)            # ascending
    idx = torch.flip(torch.argsort(evals), (0,))[:n_components]
    return PCA(mean, evecs[:, idx], evals[idx])


def fit_pca(x, n_components: int) -> PCA:
    """x: (n, d) flat features."""
    return _pca_from_moments(torch.sum(x, dim=0), x.T @ x, x.shape[0],
                             n_components)


def fit_pca_federated(xs: Sequence[torch.Tensor], n_components: int) -> PCA:
    """Aggregate the per-client moment sums of a list of (n_i, d) arrays
    into one shared basis."""
    s1 = sum(torch.sum(x, dim=0) for x in xs)
    s2 = sum(x.T @ x for x in xs)
    return _pca_from_moments(s1, s2, sum(x.shape[0] for x in xs),
                             n_components)


def client_moments(x, mask):
    """One client's (sum x, sum x x^T) over its valid rows; x (cap, d),
    mask (cap,) {0,1}. Both are gemms, so padding rows add zero terms."""
    xm = x * mask[:, None]
    return mask @ x, xm.T @ xm


def fit_pca_federated_stacked(x, mask, n_components: int,
                              part: sh.ClientSlice | None = None) -> PCA:
    """Shared basis from a mask-padded client stack.

    x: (N, cap, d) flattened client stack; mask: (N, cap) validity. The
    clients' moment sums are aggregated as one masked gemm over the stack
    (the sum of the per-client ``xm^T xm``). Sharded, ``x`` and ``mask``
    are this rank's rows of ``part``, and the partial sums (sum x,
    sum x x^T, n) travel in one all-reduce: no raw datapoint crosses
    ranks."""
    d = x.shape[-1]
    xm = (x * mask[..., None]).reshape(-1, d)
    s1 = mask.reshape(-1) @ x.reshape(-1, d)
    s2 = xm.T @ xm
    n = torch.sum(mask)
    if part is not None:
        s1, s2, n = part.psum((s1, s2, n))
    return _pca_from_moments(s1, s2, n, n_components)
