"""Bounded retry queue for failed D2D reserve transfers (the port's own copy
of ``repro.faults.retry``).

The exchange plane samples per-link channel failure (``ExchangeResult.fail``)
but used to drop failed transfers on the floor — the receiver simply never
got its reserve payload.  :class:`RetryQueue` closes that loop at the
orchestrator level: failed live links are *offered* to the queue, re-taken
in later segments after a per-link exponential backoff, and retried through
the same device exchange program (so a retried transfer still faces the
then-current channel).  Attempts are bounded; links that stay dead are
eventually abandoned, not retried forever.

Everything is host-side Python over tiny ``(rx, tx, attempts, due)``
tuples — there is nothing device-shaped about a handful of pending links —
and the whole queue round-trips through a single ``(M, 4)`` int32 array
(:meth:`to_array` / :meth:`from_array`) so it checkpoints with the rest of
the run state and survives preemption bit-identically.

The policy lives on :class:`RetryPolicy` (an :class:`OrchestratorConfig`
field).  Disabled by default: a plain run's op stream, draws and
metrics are byte-identical to the pre-retry runtime.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    enabled: bool = False
    max_attempts: int = 3        # retries per link before abandoning it
    backoff_base: int = 1        # segments to wait before the first retry
    backoff_factor: int = 2      # exponential backoff multiplier


@dataclasses.dataclass
class _Entry:
    rx: int        # receiver (the client whose reserve payload was lost)
    tx: int        # transmitter
    attempts: int  # retries already made
    due: int       # earliest segment the link may be re-offered


class RetryQueue:
    """FIFO of failed links awaiting retry; at most one pending entry per
    (rx, tx) link and at most one retry per receiver per segment."""

    def __init__(self):
        self._q: List[_Entry] = []

    def __len__(self) -> int:
        return len(self._q)

    @property
    def links(self) -> List[Tuple[int, int]]:
        return [(e.rx, e.tx) for e in self._q]

    def offer(self, segment: int, links, policy: RetryPolicy) -> int:
        """Enqueue freshly failed ``(rx, tx)`` links.  Links already
        pending are left at their existing backoff (the live exchange
        re-failing a link is not a retry attempt).  Returns how many new
        entries were added."""
        if not policy.enabled:
            return 0
        pending = {(e.rx, e.tx) for e in self._q}
        added = 0
        for rx, tx in links:
            if (int(rx), int(tx)) in pending:
                continue
            pending.add((int(rx), int(tx)))
            self._q.append(_Entry(int(rx), int(tx), 0,
                                  segment + policy.backoff_base))
            added += 1
        return added

    def take_due(self, segment: int) -> List[_Entry]:
        """Pop the entries eligible to retry at ``segment``: due, and at
        most one per receiver (a receiver's reserve slots are rewritten
        wholesale by the exchange program, so one in-flight retry per
        receiver per segment).  Queue order breaks ties — oldest first."""
        taken, keep, seen_rx = [], [], set()
        for e in self._q:
            if e.due <= segment and e.rx not in seen_rx:
                taken.append(e)
                seen_rx.add(e.rx)
            else:
                keep.append(e)
        self._q = keep
        return taken

    def resolve(self, segment: int, entry: _Entry, delivered: bool,
                policy: RetryPolicy) -> bool:
        """Record a retry outcome.  Delivered or out of attempts → the
        entry is dropped; otherwise it re-queues with exponential backoff.
        Returns True iff the link will be retried again."""
        attempts = entry.attempts + 1
        if delivered or attempts >= policy.max_attempts:
            return False
        self._q.append(_Entry(
            entry.rx, entry.tx, attempts,
            segment + policy.backoff_base * policy.backoff_factor ** attempts))
        return True

    # -- checkpoint round-trip ------------------------------------------
    def to_array(self) -> np.ndarray:
        """Queue state as an (M, 4) int32 array: rx, tx, attempts, due."""
        if not self._q:
            return np.zeros((0, 4), dtype=np.int32)
        return np.asarray([[e.rx, e.tx, e.attempts, e.due]
                           for e in self._q], dtype=np.int32)

    @classmethod
    def from_array(cls, arr: np.ndarray) -> "RetryQueue":
        arr = np.asarray(arr)
        if arr.ndim != 2 or arr.shape[1] != 4:
            raise ValueError(
                f"retry-queue checkpoint must be (M, 4), got {arr.shape}")
        q = cls()
        q._q = [_Entry(*map(int, row)) for row in arr]
        return q
