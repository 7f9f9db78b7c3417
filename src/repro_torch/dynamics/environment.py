"""The environment process: explicit, evolving D2D channel and availability
(mirrors ``repro.dynamics.environment``).

Device positions, the per-link fading matrix and the per-client availability
mask live in an :class:`EnvState` that :func:`env_step` advances once per
orchestrator segment according to a :class:`ScenarioConfig`:

  * positions follow a reflected Gaussian random walk
    (``channel.positions_step``),
  * fading follows a positive log-AR(1) Gauss-Markov process
    (``channel.fading_step``),
  * availability is i.i.d. churn or a flash-crowd arrival ramp.

The draws are inputs: :func:`env_init` takes the initial positions and
fading (the one-shot pipeline's channel draws, so a frozen environment's
``rss`` is the pipeline's snapshot), and :func:`env_step` takes one
:class:`EnvDraws` per segment.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import channel as ch
from repro_torch.dynamics.scenarios import ScenarioConfig


class EnvState(NamedTuple):
    positions: torch.Tensor   # (N, 2) device coordinates
    fading: torch.Tensor      # (N, N) positive per-link fading
    rss: torch.Tensor         # (N, N) current RSS snapshot (diag = +inf)
    available: torch.Tensor   # (N,) bool, client online this segment
    t: torch.Tensor           # () int32 segment counter


class EnvDraws(NamedTuple):
    """One segment's draws: the mobility normals (N, 2), the fading normals
    (N, N) and the churn uniforms (N,)."""
    pos_eps: torch.Tensor
    fade_eps: torch.Tensor
    churn_u: torch.Tensor


def env_init(positions, fading, ccfg: ch.ChannelConfig = ch.ChannelConfig(),
             scn: ScenarioConfig | None = None) -> EnvState:
    """Initial environment state from the initial positions and fading;
    ``rss`` is ``rss_from_state(positions, fading)``."""
    n = positions.shape[0]
    dev = positions.device
    rss = ch.rss_from_state(positions, fading, ccfg)
    avail = torch.ones((n,), dtype=torch.bool, device=dev)
    if scn is not None and scn.flash_crowd:
        avail = _flash_crowd_mask(n, 0, scn, dev)
    return EnvState(positions, fading, rss, avail,
                    torch.zeros((), dtype=torch.int32, device=dev))


def _flash_crowd_mask(n: int, t, scn: ScenarioConfig, device) -> torch.Tensor:
    """Deterministic arrival ramp: the first ``k(t)`` clients are online,
    k ramping linearly from ``flash_initial_frac * n`` to ``n``. Computed in
    float32 as the reference does; ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    t = torch.as_tensor(t, device=device).to(torch.float32)
    frac = torch.clamp_max(scn.flash_initial_frac
                           + (1.0 - scn.flash_initial_frac)
                           * (t / max(scn.flash_ramp_segments, 1)), 1.0)
    k = torch.clamp_min(torch.round(frac * n), 1).to(torch.int32)
    return torch.arange(n, device=device) < k


def env_step(state: EnvState, draws: EnvDraws, scn: ScenarioConfig,
             ccfg: ch.ChannelConfig = ch.ChannelConfig()) -> EnvState:
    """Advance the environment one segment."""
    pos, fade = state.positions, state.fading
    if scn.mobility_step > 0.0:
        pos = ch.positions_step(pos, draws.pos_eps, scn.mobility_step, ccfg)
    if scn.fading_sigma > 0.0 and scn.fading_rho < 1.0:
        fade = ch.fading_step(fade, draws.fade_eps, scn.fading_rho,
                              scn.fading_sigma)
    rss = ch.rss_from_state(pos, fade, ccfg)

    n = pos.shape[0]
    dev = pos.device
    t = state.t + 1
    if scn.flash_crowd:
        avail = _flash_crowd_mask(n, t, scn, dev)
    elif scn.churn_prob > 0.0:
        u = draws.churn_u
        avail = u >= scn.churn_prob
        # never let the whole fleet vanish: keep the client of the largest
        # uniform (the reference draws its argmax from the same uniforms)
        avail = torch.where(torch.any(avail), avail,
                            torch.arange(n, device=dev) == torch.argmax(u))
    else:
        avail = torch.ones((n,), dtype=torch.bool, device=dev)
    return EnvState(pos, fade, rss, avail, t)


def stragglers_from(avail) -> tuple:
    """Offline clients as the straggler tuple ``fl_train`` expects."""
    return tuple(int(i) for i in
                 np.nonzero(~np.asarray(torch.as_tensor(avail).cpu()))[0])
