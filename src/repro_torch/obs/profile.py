"""Opt-in ``torch.profiler`` bridge: a Chrome trace around a named region.

Wall-clock spans attribute *host* time; when a phase needs device-level
attribution (which kernel, how busy the card is, how much of a run is
launch overhead), capture a profiler trace around it:

    REPRO_PROFILE=runs/obs/profile python3 my_script.py

or ``maybe_profile(tag, out_dir=...)`` in code. Each region records the
host's operators and, when a card is present, its kernels and copies, and
writes ``<dir>/<tag>/trace.json`` (``export_chrome_trace``; open it in
``chrome://tracing`` or Perfetto). While the region is open every
``obs.span`` also opens a ``record_function`` range of its name, so the
trace shows the phases around the kernels.

One profiler runs at a time, so a nested region is ignored (the outermost
wins) rather than erroring, and with no directory configured the context
manager is a flag check.
"""
from __future__ import annotations

import contextlib
import os

from repro_torch.obs import tracer as _tracer

__all__ = ["profile_dir", "maybe_profile", "TRACE_NAME"]

_ENV = "REPRO_PROFILE"
TRACE_NAME = "trace.json"
_tracing = False


def profile_dir() -> str | None:
    """The configured trace directory, or None (profiling off)."""
    return os.environ.get(_ENV) or None


@contextlib.contextmanager
def maybe_profile(tag: str, out_dir: str | None = None):
    """Capture a ``torch.profiler`` trace of the enclosed region as
    ``<out_dir>/<tag>/trace.json`` when profiling is configured (argument
    or ``REPRO_PROFILE``); otherwise do nothing."""
    global _tracing
    d = out_dir or profile_dir()
    if d is None or _tracing:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    path = os.path.join(d, tag)
    os.makedirs(path, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    _tracing = True
    prof = profile(activities=activities)
    prof.__enter__()
    _tracer._set_record(True)
    try:
        yield
    finally:
        _tracer._set_record(False)
        prof.__exit__(None, None, None)
        _tracing = False
        prof.export_chrome_trace(os.path.join(path, TRACE_NAME))
