"""Realisation of fault plans onto the environment state (mirrors
``repro.faults.inject``).

Two entry points, both pure functions of ``(plan, segment, ...)`` and the
events' uniforms:

  * :func:`apply_availability` overlays crash pulses and regional outages
    onto the availability mask drawn by the environment process;
  * :func:`apply_pfail` overlays link bursts onto the channel's failure
    probability matrix.

Each event takes its own uniforms, (N,) per crash pulse and (N, N) per link
burst, in the plan's order. The draw source derives them from the event's
*start* segment only, so the same clients stay down and the same links stay
hit for the event's whole window, and a resumed run sees the victim sets the
uninterrupted run saw. Regional outages use the environment's positions.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.channel import degrade_links
from repro_torch.faults.plan import FaultPlan


def _check_uniforms(name: str, uniforms, events):
    """One set of uniforms per event: a short list would drop events."""
    if len(uniforms) != len(events):
        raise ValueError(f"{name}: {len(uniforms)} uniform draws for "
                         f"{len(events)} events; every event needs its own")


def apply_availability(plan: FaultPlan, segment: int, positions, avail,
                       crash_u: Sequence[torch.Tensor]):
    """Overlay the plan's crash pulses and regional outages onto ``avail``.

    ``positions``: the environment's (N, 2) device positions; ``avail``:
    the (N,) boolean availability; ``crash_u[i]``: the (N,) uniforms of
    ``plan.crashes[i]``. If the faults would take every client down,
    client 0 stays up (the environment's churn guard does the same)."""
    _check_uniforms("crash_u", crash_u, plan.crashes)
    if not plan.perturbs_availability:
        return avail
    n = avail.shape[0]
    down = torch.zeros((n,), dtype=torch.bool, device=avail.device)
    for c, u in zip(plan.crashes, crash_u):
        if c.active(segment):
            down = down | (u < c.frac)
    for r in plan.regions:
        if r.active(segment):
            # filled on the device: a host tensor would be a blocking copy
            center = torch.stack([torch.full((), c, dtype=positions.dtype,
                                             device=positions.device)
                                  for c in r.center])
            dist = torch.linalg.norm(positions - center[None, :], dim=-1)
            down = down | (dist <= r.radius)
    out = avail & ~down
    rows = torch.arange(n, device=avail.device)
    return torch.where(torch.any(out), out, rows == 0)


def apply_pfail(plan: FaultPlan, segment: int, p_fail,
                burst_u: Sequence[torch.Tensor]):
    """Overlay the plan's link bursts onto the (N, N) failure probability:
    each active burst floors the links where ``burst_u[i] < frac`` at its
    ``p_fail`` level."""
    _check_uniforms("burst_u", burst_u, plan.link_bursts)
    if not plan.perturbs_links:
        return p_fail
    out = p_fail
    for b, u in zip(plan.link_bursts, burst_u):
        if b.active(segment):
            out = degrade_links(out, u < b.frac, b.p_fail)
    return out
