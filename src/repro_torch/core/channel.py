"""D2D channel model (paper Sec. II-C) and its temporal evolution (mirrors
``repro.core.channel``).

P_D(i,j) = 1 - exp( -(2^r - 1) * sigma^2 / W_ij )

W is the received signal strength from device positions (log-distance path
loss) times a per-link fading draw. Positions and fading are inputs; the
``make_positions``/``init_fading`` helpers draw them from a generator.

The dynamics (``repro_torch.dynamics``) keep the channel state explicit and
evolve it between FL segments: :func:`positions_step` (a Gaussian random
walk reflected into the area) and :func:`fading_step` (a log-domain AR(1)).
Both take their standard normals ``eps`` as inputs.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    rate: float = 1.0          # r, bits/s/Hz
    noise_power: float = 0.05  # sigma^2
    tx_power: float = 1.0
    pathloss_exp: float = 2.5
    area: float = 1.0          # devices placed uniformly in [0, area]^2
    min_dist: float = 0.05


def make_positions(generator: torch.Generator, n: int,
                   cfg: ChannelConfig = ChannelConfig()):
    return torch.rand((n, 2), generator=generator,
                      device=generator.device) * cfg.area


def init_fading(generator: torch.Generator, n: int):
    """Per-link (asymmetric) Rayleigh-like fading draw: Exp(1) * 0.5 + 0.75."""
    e = torch.empty((n, n), device=generator.device).exponential_(
        generator=generator)
    return e * 0.5 + 0.75


def path_loss(pos, cfg: ChannelConfig = ChannelConfig()):
    """Symmetric log-distance path-loss matrix from device positions."""
    d = torch.linalg.norm(pos[:, None, :] - pos[None, :, :], dim=-1)
    d = torch.clamp_min(d, cfg.min_dist)
    return cfg.tx_power * d ** (-cfg.pathloss_exp)


def rss_from_state(pos, fade, cfg: ChannelConfig = ChannelConfig()):
    """W[i, j]: RSS at i receiving from j, from explicit channel state."""
    w = path_loss(pos, cfg) * fade
    w.fill_diagonal_(float("inf"))
    return w


def failure_prob(w, cfg: ChannelConfig = ChannelConfig()):
    """P_D matrix from the RSS matrix (paper Sec. II-C)."""
    snr_req = (2.0 ** cfg.rate - 1.0) * cfg.noise_power
    p = 1.0 - torch.exp(-snr_req / w)
    p.fill_diagonal_(1.0)   # no self links
    return p


def rss_from_positions(generator: torch.Generator, pos,
                       cfg: ChannelConfig = ChannelConfig()):
    """W[i, j] from positions and a fading draw from ``generator``."""
    return rss_from_state(pos, init_fading(generator, pos.shape[0]).to(
        pos.device), cfg)


def make_rss(generator: torch.Generator, n: int,
             cfg: ChannelConfig = ChannelConfig()):
    """One channel snapshot: positions, then fading, from ``generator``."""
    return rss_from_positions(generator, make_positions(generator, n, cfg),
                              cfg)


def positions_step(pos, eps, step_std: float,
                   cfg: ChannelConfig = ChannelConfig()):
    """One mobility step: ``pos + eps * step_std`` reflected into
    [0, area]^2 (``eps``: (N, 2) standard normals). Reflection, not
    clipping, keeps the stationary distribution uniform."""
    p = torch.abs(pos + eps * step_std)        # bounce off 0
    return cfg.area - torch.abs(cfg.area - p)  # bounce off area


def fading_step(fade, eps, rho: float, sigma: float):
    """One block-fading step, AR(1) in the log domain:

        log f_t = rho * log f_{t-1} + sqrt(max(1 - rho^2, 0)) * sigma * eps

    ``eps``: (N, N) standard normals. The coefficient is computed as the
    reference does: the Python float ``1 - rho^2`` enters a float32 max and
    square root."""
    c = torch.sqrt(torch.clamp_min(
        torch.full((), 1.0 - rho * rho, dtype=torch.float32,
                   device=fade.device), 0.0))
    return torch.exp(rho * torch.log(fade) + c * sigma * eps)


def degrade_links(p_fail, hit_mask, level):
    """Raise the failure probability of the links in ``hit_mask`` to at
    least ``level``. ``hit_mask`` is per-link (N, N) or per-transmitter
    (N,), broadcast along the last axis."""
    hit = torch.broadcast_to(torch.as_tensor(hit_mask, device=p_fail.device),
                             p_fail.shape)
    return torch.where(hit, torch.clamp_min(p_fail, level), p_fail)
