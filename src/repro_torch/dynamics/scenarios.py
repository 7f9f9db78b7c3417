"""Scenario registry: named presets of environment dynamics (the port's own
copy of ``repro.dynamics.scenarios``).

A scenario bundles the knobs of the environment process
(:mod:`repro_torch.dynamics.environment`) — fading correlation, device mobility,
client availability — into one immutable config the orchestrator and the
benchmarks select by name.  The built-ins cover the paper's static snapshot
plus the regimes its companion works motivate (MARL graph discovery over
fading channels, arXiv 2503.23218; D2D edge optimization with churn,
arXiv 2404.09861):

``static``
    Frozen channel, everyone always available — the paper's Figs. 3–6
    setting.  With re-discovery disabled the orchestrator reproduces the
    one-shot pipeline bit-for-bit (tested).
``fading``
    Stationary devices, block fading decorrelating across segments
    (log-AR(1), rho=0.7) — link qualities drift, graph goes stale.
``mobility``
    Devices random-walk through the area with mildly correlated fading —
    the *topology* itself drifts.
``churn``
    Static channel, but each client is independently offline (straggler)
    per segment with probability 0.25.
``flash-crowd``
    Only a third of the fleet is online at the start; the rest arrive in
    waves over the first segments — availability ramps to 100%.

A scenario may additionally carry a :class:`~repro_torch.faults.FaultPlan`
(``faults``): declarative crash pulses, correlated regional outages, burst
link outages and simulated host preemption that the orchestrator overlays
onto the environment process deterministically (see
:mod:`repro_torch.faults`).
Three fault presets ship built-in:

``burst-outage``
    Fading channel + a 2-segment burst knocking out 60% of D2D links
    (failure probability floored at 0.97) — the regime where the retry
    queue earns its keep.
``regional-failure``
    i.i.d. churn + a 2-segment regional blackout (every device near
    (0.3, 0.3) goes dark) followed by a 30% crash pulse — correlated
    availability loss beyond what churn models.
``preempt-resume``
    Fading channel + simulated host preemption at segment 2: the
    orchestrator raises :class:`~repro_torch.faults.Preempted` there, and
    a run resumed from the latest checkpoint continues bit-identically.

``register_scenario`` adds new presets (e.g. from experiments) without
touching this module.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.faults.plan import (CrashPulse, FaultPlan, LinkBurst,
                                     RegionalOutage)


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    name: str
    # channel evolution (per segment step)
    fading_rho: float = 1.0      # AR(1) correlation; 1.0 freezes fading
    fading_sigma: float = 0.0    # stationary log-std of the fading process
    mobility_step: float = 0.0   # random-walk std (area units) per segment
    # availability process
    churn_prob: float = 0.0      # P(client offline) per segment, i.i.d.
    flash_crowd: bool = False    # staged arrival instead of i.i.d. churn
    flash_initial_frac: float = 0.34   # fraction online at t=0
    flash_ramp_segments: int = 3       # segments until everyone is online
    # deterministic fault overlay (None = fault-free)
    faults: Optional[FaultPlan] = None

    @property
    def channel_is_static(self) -> bool:
        return (self.mobility_step == 0.0
                and (self.fading_sigma == 0.0 or self.fading_rho == 1.0))


_REGISTRY: Dict[str, ScenarioConfig] = {}


def register_scenario(cfg: ScenarioConfig) -> ScenarioConfig:
    """Add (or replace) a named scenario preset."""
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_scenario(scenario) -> ScenarioConfig:
    """Resolve a scenario by name; a ScenarioConfig passes through."""
    if isinstance(scenario, ScenarioConfig):
        return scenario
    try:
        return _REGISTRY[scenario]
    except KeyError:
        raise KeyError(f"unknown scenario {scenario!r}; "
                       f"registered: {sorted(_REGISTRY)}") from None


def available_scenarios() -> list:
    return sorted(_REGISTRY)


register_scenario(ScenarioConfig("static"))
register_scenario(ScenarioConfig("fading", fading_rho=0.7, fading_sigma=0.6))
register_scenario(ScenarioConfig("mobility", fading_rho=0.9,
                                 fading_sigma=0.3, mobility_step=0.12))
register_scenario(ScenarioConfig("churn", churn_prob=0.25))
register_scenario(ScenarioConfig("flash-crowd", flash_crowd=True))

# Fault presets (see module docstring).  Windows start at segment 1: the
# fault plane overlays the *evolving* environment, and segment 0's channel
# and availability are the pipeline's initial draw by construction.
register_scenario(ScenarioConfig(
    "burst-outage", fading_rho=0.9, fading_sigma=0.3,
    faults=FaultPlan(link_bursts=(
        LinkBurst(start=1, duration=2, frac=0.6, p_fail=0.97),))))
register_scenario(ScenarioConfig(
    "regional-failure", churn_prob=0.1,
    faults=FaultPlan(
        regions=(RegionalOutage(start=1, duration=2,
                                center=(0.3, 0.3), radius=0.4),),
        crashes=(CrashPulse(start=3, duration=1, frac=0.3),))))
register_scenario(ScenarioConfig(
    "preempt-resume", fading_rho=0.7, fading_sigma=0.6,
    faults=FaultPlan(preempt_at=2)))
