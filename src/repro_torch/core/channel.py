"""D2D channel model (paper Sec. II-C; mirrors the one-shot part of
``repro.core.channel``).

P_D(i,j) = 1 - exp( -(2^r - 1) * sigma^2 / W_ij )

W is the received signal strength from device positions (log-distance path
loss) times a per-link fading draw. Positions and fading are inputs; the
``make_positions``/``init_fading`` helpers draw them from a generator.
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
