"""Nestable span tracer: monotonic wall-clock phases with counter deltas.

A :func:`span` turns each hot-path phase into a recorded event:

    with span("re-discover", mode="online"):
        graph = ql.discover_graph(...)

or, as a decorator around a whole stage::

    @span.wrap("cluster")
    def cluster_clients(...): ...

Spans nest (each records its depth), carry scalar attributes, and snapshot
the counters (``obs.counters``) at both boundaries, so every event knows how
many kernel-library loads and counted device-to-host transfers happened
inside it, its children's included; readers that want exclusive time
subtract child durations (:mod:`repro_torch.obs.report` does).

Cost model: when neither tracing nor a profile region is on (the default)
``span(...)`` allocates one small handle whose ``__enter__``/``__exit__``
are a single flag check: no clock is read and no event is stored. Spans
sit at phase granularity (a handful per orchestrator segment, never inside
a training round), and ``chip_smoke.py`` phase 9 (d) measures the disabled
cost against a full-width online run.

Timing semantics under CUDA's asynchronous stream: a span measures *host*
wall-clock between its boundaries. A phase that only enqueues kernels
records its launch cost; the device time it enqueued lands in whichever
later span first blocks (a host read such as a failed-link mask, a
segment's closing sync, the single ``metrics-materialize`` transfer). The
tracer inserts no ``torch.cuda.synchronize``, so it never changes the
program it measures.

While a :func:`repro_torch.obs.profile.maybe_profile` region is open, each
span also opens a ``torch.profiler.record_function`` range of its name, so
the profiler's trace carries the phase names that eager CUDA kernels lack.

Not thread-safe by design: the tracer mirrors the repo's single-threaded
run loops.
"""
from __future__ import annotations

import functools
import time
from typing import Any, Dict, List, Optional

from repro_torch.obs import counters as _counters

__all__ = ["SpanEvent", "span", "enabled", "start", "stop", "events",
           "drain", "phase_totals"]


class SpanEvent:
    """One closed span: name, wall-clock window, nesting, counter deltas."""

    __slots__ = ("name", "t0", "dur", "depth", "parent", "attrs",
                 "compiles", "transfers", "bytes_fetched",
                 "live_arrays", "live_bytes")

    def __init__(self, name, t0, dur, depth, parent, attrs,
                 compiles, transfers, bytes_fetched,
                 live_arrays=None, live_bytes=None):
        self.name = name
        self.t0 = t0                    # seconds since tracer start
        self.dur = dur                  # seconds
        self.depth = depth              # 0 = top level
        self.parent = parent            # index into the event list, or None
        self.attrs = attrs              # scalar labels ({} when none)
        self.compiles = compiles        # kernel-library loads inside
        self.transfers = transfers      # counters.device_get calls inside
        self.bytes_fetched = bytes_fetched
        self.live_arrays = live_arrays  # optional device-memory snapshot
        self.live_bytes = live_bytes    # (at span exit; REPRO_OBS_MEM=1)

    def to_dict(self) -> Dict[str, Any]:
        d = {"type": "span", "name": self.name, "t0": self.t0,
             "dur": self.dur, "depth": self.depth, "parent": self.parent,
             "compiles": self.compiles, "transfers": self.transfers,
             "bytes_fetched": self.bytes_fetched}
        if self.attrs:
            d["attrs"] = self.attrs
        if self.live_arrays is not None:
            d["live_arrays"] = self.live_arrays
            d["live_bytes"] = self.live_bytes
        return d

    def __repr__(self):
        return (f"SpanEvent({self.name!r}, dur={self.dur:.6f}, "
                f"depth={self.depth}, compiles={self.compiles}, "
                f"transfers={self.transfers})")


# Module-level tracer state. `_hot` is the one flag the disabled fast path
# reads: tracing or a profile region is on. Everything else is only touched
# while one of them is.
_enabled = False
_record = False               # a profile region is open (profile.py)
_hot = False
_t_start = 0.0
_events: List[SpanEvent] = []
_stack: List[list] = []       # open frames: [name, attrs, t0, counters]
_snapshot_memory = False
_on_close = None              # manifest hook: called with each closed event


def enabled() -> bool:
    return _enabled


def _set_record(on: bool) -> None:
    """Open (or close) profiler ranges around spans; profile.py calls
    this at a profile region's boundaries."""
    global _record, _hot
    _record = bool(on)
    _hot = _enabled or _record


def start(snapshot_memory: bool = False, on_close=None) -> None:
    """Begin tracing: reset the event list and the counter epoch."""
    global _enabled, _hot, _t_start, _snapshot_memory, _on_close
    _events.clear()
    _stack.clear()
    _counters.set_active(True)
    _snapshot_memory = snapshot_memory
    _on_close = on_close
    _t_start = time.perf_counter()
    _enabled = True
    _hot = True


def stop() -> List[SpanEvent]:
    """Stop tracing and return the recorded events (open spans discarded)."""
    global _enabled, _hot, _on_close
    _enabled = False
    _hot = _record
    _on_close = None
    _counters.set_active(False)
    _stack.clear()
    return list(_events)


def events() -> List[SpanEvent]:
    """The completed spans recorded so far (tracing keeps running)."""
    return list(_events)


def drain() -> List[SpanEvent]:
    """Return completed spans and clear the list: per-row attribution pulls
    one run's spans without stopping the tracer."""
    out = list(_events)
    _events.clear()
    return out


class _SpanHandle:
    """Context manager for one span; ``span.wrap`` builds the decorator."""

    __slots__ = ("name", "attrs", "_live", "_range")

    def __init__(self, name: str, attrs: Optional[dict]):
        self.name = name
        self.attrs = attrs
        self._live = False
        self._range = None

    def __enter__(self):
        if not _hot:
            return self
        if _record:
            from torch.profiler import record_function
            self._range = record_function(self.name)
            self._range.__enter__()
        if _enabled:
            self._live = True
            _stack.append([self.name, self.attrs, time.perf_counter(),
                           _counters.snapshot()])
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._range is not None:
            rng, self._range = self._range, None
            rng.__exit__(exc_type, exc, tb)
        if not self._live:
            return False
        self._live = False
        t1 = time.perf_counter()
        name, attrs, t0, c0 = _stack.pop()
        c1 = _counters.snapshot()
        depth = len(_stack)
        # Children close before their parent, so a parent's event index is
        # unknown here; events carry (close order, depth) instead and readers
        # rebuild the tree from that: a span's parent is the nearest *later*
        # event with a smaller depth (see repro_torch/obs/report.py).
        ev = SpanEvent(
            name=name, t0=t0 - _t_start, dur=t1 - t0, depth=depth,
            parent=None, attrs=attrs or {},
            compiles=c1[0] - c0[0], transfers=c1[1] - c0[1],
            bytes_fetched=c1[2] - c0[2])
        if _snapshot_memory:
            ev.live_arrays, ev.live_bytes = _counters.live_memory()
        _events.append(ev)
        if _on_close is not None:
            _on_close(ev)
        return False


def span(name: str, **attrs) -> _SpanHandle:
    """A context manager timing one phase; no-op unless tracing (or a
    profile region) is active.

    Keyword arguments become the event's ``attrs`` (keep them scalar: they
    are written verbatim into the JSONL manifest)."""
    return _SpanHandle(name, attrs or None)


def _wrap(name: str, **attrs):
    """Decorator form: time every call of ``fn`` as a ``name`` span."""
    def deco(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _hot:              # skip even the handle allocation
                return fn(*args, **kwargs)
            with span(name, **attrs):
                return fn(*args, **kwargs)
        return inner
    return deco


span.wrap = _wrap


def phase_totals(evs: Optional[List[SpanEvent]] = None) -> Dict[str, dict]:
    """Aggregate events by span name: total/count/mean seconds + counter
    sums."""
    evs = events() if evs is None else evs
    out: Dict[str, dict] = {}
    for e in evs:
        d = out.setdefault(e.name, {"total": 0.0, "count": 0,
                                    "compiles": 0, "transfers": 0})
        d["total"] += e.dur
        d["count"] += 1
        d["compiles"] += e.compiles
        d["transfers"] += e.transfers
    for d in out.values():
        d["mean"] = d["total"] / d["count"]
    return out
