"""Local trust matrices (paper Eq. 1; mirrors ``repro.core.trust``).

T_j in {0,1}^{N x k}: T_j[i, n] = 1 iff transmitter c_j trusts receiver c_i
with its cluster n. The port keeps the N matrices stacked as one (N_tx, N_rx,
k) int8 tensor, ``trust[j, i, n] = T_j[i, n]``.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device


def draw_trust_uniforms(generator: torch.Generator, n_clients: int,
                        n_clusters: int) -> torch.Tensor:
    """The (N_tx, N_rx, k) uniforms :func:`make_trust` thresholds."""
    return torch.rand((n_clients, n_clients, n_clusters),
                      generator=generator, device=generator.device)


def make_trust(u: torch.Tensor, p_trust: float = 0.9) -> torch.Tensor:
    """Bernoulli(p_trust) trust from uniforms u (N_tx, N_rx, k); every
    transmitter trusts itself."""
    t = (u < p_trust).to(torch.int8)
    n = t.shape[0]
    idx = torch.arange(n, device=t.device)
    t[idx, idx] = 1
    return t


def full_trust(n_clients: int, n_clusters, device="cuda"):
    """Every transmitter trusts every receiver with every cluster: the
    stacked (N_tx, N_rx, k) ones for one ``n_clusters``, or the list of
    (N_rx, k_j) ones matrices for per-transmitter counts, on the card
    unless ``device`` says otherwise."""
    kw = dict(dtype=torch.int8, device=resolve_device(device))
    if isinstance(n_clusters, int):
        return torch.ones((n_clients, n_clients, n_clusters), **kw)
    return [torch.ones((n_clients, k), **kw) for k in n_clusters]
