"""Declarative fault plans for the online federation loop (the port's own
copy of ``repro.faults.plan``).

A :class:`FaultPlan` is a frozen, fully declarative description of every
fault a run will experience — which segments, which fraction of the fleet,
which region, which links — with *no* randomness of its own.  Realisation
(which concrete clients crash, which links burst) happens in
:mod:`repro_torch.faults.inject` from uniforms the orchestrator's draw
source gives per event, so two runs with the same draws and plan see
identical faults, and a run resumed from a checkpoint re-derives exactly the
faults the uninterrupted run would have seen.

Plans ride on :class:`repro_torch.dynamics.scenarios.ScenarioConfig` (its
``faults`` field), making fault regimes first-class named scenarios — see
``burst-outage``, ``regional-failure`` and ``preempt-resume`` in the
scenario registry.

Fault vocabulary (all windows are half-open segment ranges
``[start, start + duration)``):

:class:`CrashPulse`
    An i.i.d. fraction of the fleet crashes for the window and rejoins
    after — straggler bursts beyond what the availability process models.
:class:`RegionalOutage`
    Every client within ``radius`` of ``center`` goes dark — correlated
    failure (a basestation or power-domain loss), the case i.i.d. churn
    can't represent.
:class:`LinkBurst`
    A fraction of D2D links has its failure probability floored at
    ``p_fail`` — burst interference on the exchange channel without
    touching availability.
``preempt_at``
    Simulated host preemption: the orchestrator raises
    :class:`Preempted` at that segment boundary (before doing the
    segment's work), exercising the checkpoint/resume path.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class CrashPulse:
    start: int
    duration: int = 1
    frac: float = 0.3            # expected fraction of clients taken down

    def active(self, segment: int) -> bool:
        return self.start <= segment < self.start + self.duration


@dataclasses.dataclass(frozen=True)
class RegionalOutage:
    start: int
    duration: int = 1
    center: Tuple[float, float] = (0.5, 0.5)   # area units
    radius: float = 0.3

    def active(self, segment: int) -> bool:
        return self.start <= segment < self.start + self.duration


@dataclasses.dataclass(frozen=True)
class LinkBurst:
    start: int
    duration: int = 1
    frac: float = 0.5            # expected fraction of links hit
    p_fail: float = 0.97         # failure-probability floor on hit links

    def active(self, segment: int) -> bool:
        return self.start <= segment < self.start + self.duration


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    crashes: Tuple[CrashPulse, ...] = ()
    regions: Tuple[RegionalOutage, ...] = ()
    link_bursts: Tuple[LinkBurst, ...] = ()
    preempt_at: Optional[int] = None

    @property
    def perturbs_availability(self) -> bool:
        return bool(self.crashes or self.regions)

    @property
    def perturbs_links(self) -> bool:
        return bool(self.link_bursts)

    def active(self, segment: int) -> Tuple[str, ...]:
        """Labels of the fault events covering ``segment`` (annotation, not
        control flow)."""
        out = []
        for c in self.crashes:
            if c.active(segment):
                out.append(f"crash[{c.start}+{c.duration}]")
        for r in self.regions:
            if r.active(segment):
                out.append(f"region[{r.start}+{r.duration}]")
        for b in self.link_bursts:
            if b.active(segment):
                out.append(f"burst[{b.start}+{b.duration}]")
        return tuple(out)


class Preempted(RuntimeError):
    """Simulated host preemption: raised by the orchestrator at the fault
    plan's ``preempt_at`` segment boundary, after the previous segment's
    checkpoint was written.  Carries what a supervisor needs to restart."""

    def __init__(self, segment: int, checkpoint: Optional[str]):
        self.segment = segment
        self.checkpoint = checkpoint
        super().__init__(
            f"orchestrator preempted at segment boundary {segment} "
            f"(resume from {checkpoint!r})")
