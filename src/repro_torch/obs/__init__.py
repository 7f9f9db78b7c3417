"""Runtime observability plane of the port: spans, counters, manifests,
profiling (mirrors ``repro.obs``).

The library code (orchestrator, pipeline, exchange, FL, RL, clustering)
carries :func:`span` phase labels at the reference's sites, with the
reference's names and attributes, that cost one flag check when
observability is off; turning it on records every phase's host wall time
plus the kernel-library loads and counted device-to-host transfers it
performed:

    from repro_torch import obs

    obs.enable(manifest="runs/obs/myrun.jsonl", meta={"scenario": "fading"})
    run_orchestrator(...)
    summary = obs.disable()          # totals + closes the manifest
    # per-phase table: python -m repro_torch.obs.report runs/obs/myrun.jsonl

Environment switches (for programs that cannot call :func:`enable`):

  * ``REPRO_OBS=1``            trace in memory (``enable_from_env()``)
  * ``REPRO_OBS=path.jsonl``   trace and stream a manifest to the path
  * ``REPRO_OBS_MEM=1``        also snapshot live device memory at every
    span exit (diagnosis runs only)
  * ``REPRO_PROFILE=dir``      capture ``torch.profiler`` traces around
    profiled regions (see :mod:`repro_torch.obs.profile`)

Submodules: ``tracer`` (spans), ``counters`` (library loads, transfers),
``manifest`` (JSONL writer and reader), ``profile`` (``torch.profiler``
bridge), ``report`` (the per-phase table). Importing the package touches
no global torch state.
"""
from __future__ import annotations

import os
from typing import Optional

from repro_torch.obs import counters as _counters
from repro_torch.obs import tracer as _tracer
from repro_torch.obs.manifest import ManifestWriter, read_manifest  # noqa: F401
from repro_torch.obs.profile import maybe_profile, profile_dir  # noqa: F401
from repro_torch.obs.tracer import (SpanEvent, drain, enabled,  # noqa: F401
                                    events, phase_totals, span)

__all__ = ["span", "SpanEvent", "enable", "disable", "enabled",
           "enable_from_env", "events", "drain", "phase_totals",
           "counters", "mark", "ManifestWriter", "read_manifest",
           "maybe_profile", "profile_dir"]

_writer: Optional[ManifestWriter] = None


def enable(manifest: Optional[str] = None,
           meta: Optional[dict] = None, rules=None) -> None:
    """Start tracing. ``manifest`` streams events to a JSONL file as they
    close; ``meta`` (any JSON-serialisable dict) and ``rules`` (a
    ``ShardingRules`` or mesh, for the mesh shape) land in its header.
    Re-enabling restarts the trace (and closes any previous manifest)."""
    global _writer
    if _tracer.enabled():
        disable()
    if manifest is not None:
        _writer = ManifestWriter(manifest, meta=meta, rules=rules)
    _tracer.start(
        snapshot_memory=bool(os.environ.get("REPRO_OBS_MEM")),
        on_close=_writer.on_span if _writer is not None else None)


def disable() -> dict:
    """Stop tracing; returns ``{"events": [...], "totals": {...}}`` and
    finalises the manifest (totals line) if one was being written."""
    global _writer
    evs = _tracer.stop()
    if _writer is not None:
        _writer.close()
        _writer = None
    totals = {
        "wall": sum(e.dur for e in evs if e.depth == 0),
        "compiles": sum(e.compiles for e in evs if e.depth == 0),
        "transfers": sum(e.transfers for e in evs if e.depth == 0),
        "bytes_fetched": sum(e.bytes_fetched for e in evs if e.depth == 0),
    }
    return {"events": evs, "totals": totals}


def enable_from_env() -> bool:
    """Enable tracing iff ``REPRO_OBS`` is set (see module docstring);
    returns whether tracing is now on. Idempotent for long-lived programs:
    an already-running trace is left alone."""
    val = os.environ.get("REPRO_OBS", "")
    if not val:
        return False
    if _tracer.enabled():
        return True
    enable(manifest=val if val not in ("1", "true", "yes") else None)
    return True


def counters() -> dict:
    """Process-wide counter snapshot (zeros until tracing first counts)."""
    c, t, b = _counters.snapshot()
    return {"compiles": c, "transfers": t, "bytes_fetched": b}


def mark(name: str, **fields) -> None:
    """Write an annotation line to the active manifest (no-op without
    one); the orchestrator marks each retry's outcome this way."""
    if _writer is not None:
        _writer.mark(name, **fields)
