"""Fault plane of the online federation loop (mirrors ``repro.faults``):
declarative fault plans (:mod:`~repro_torch.faults.plan`), their realisation
onto availability and link state (:mod:`~repro_torch.faults.inject`) and the
bounded retry queue for failed D2D transfers
(:mod:`~repro_torch.faults.retry`)."""
from repro_torch.faults.plan import (CrashPulse, FaultPlan, LinkBurst,
                                     Preempted, RegionalOutage)
from repro_torch.faults.inject import apply_availability, apply_pfail
from repro_torch.faults.retry import RetryPolicy, RetryQueue

__all__ = [
    "CrashPulse", "FaultPlan", "LinkBurst", "Preempted", "RegionalOutage",
    "apply_availability", "apply_pfail", "RetryPolicy", "RetryQueue",
]
