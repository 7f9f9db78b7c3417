"""Per-segment metrics trace for the online simulation (mirrors
``repro.dynamics.metrics``).

Three quantities tell the story of a dynamic deployment:

  * **eval loss** — did the federation keep converging while the world
    moved underneath it?
  * **link churn** — what fraction of receivers changed transmitter since
    the previous graph (0 for a frozen graph; high churn under mobility
    means the discovered topology actually tracks the environment),
  * **delivery rate** — of the links the graph committed to, how many
    would deliver under the *current* channel: expected rate is
    ``1 - mean P_D`` over chosen links; when the exchange sampled the
    channel, the realized rate is also recorded.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

import numpy as np
import torch


@dataclasses.dataclass
class SegmentRecord:
    segment: int
    eval_loss: float                 # global recon loss at segment end
    in_edge: np.ndarray              # (N,) graph used during the segment
    link_churn: float                # frac of receivers whose tx changed
    mean_pfail: float                # mean P_D over chosen (non-self) links
    expected_delivery: float         # 1 - mean_pfail
    realized_delivery: Optional[float]  # frac of links that delivered, if
                                        # the exchange sampled the channel
    n_available: int                 # clients online this segment
    moved: int                       # datapoints exchanged this segment
    rediscovered: bool               # did an RL burst run this segment?
    eval_iters: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))
    eval_curve: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))
    # fault/retry plane (zero on fault-free runs)
    n_live: int = 0                  # live links the exchange committed to
    n_failed: int = 0                # of those, sampled channel failures
    retried: int = 0                 # queued links re-offered this segment
    retry_delivered: int = 0         # of those, delivered on the retry


class PendingSegment(NamedTuple):
    """One segment's metrics before materialisation: ``dev`` holds deferred
    device tensors (or host values), the rest is host metadata known
    synchronously. The orchestrator accumulates these and converts them to
    :class:`SegmentRecord` in a single end-of-run transfer; the checkpoint
    layer persists them (dev values materialised) so a resumed run replays
    the completed segments' records bit-identically."""
    segment: int
    rediscovered: bool
    sampled: bool                  # did the exchange sample the channel?
    host_realized: Optional[float]  # loop-plane fallback (already host)
    eval_iters: np.ndarray
    dev: dict
    retried: int = 0
    retry_delivered: int = 0


def _host(a) -> np.ndarray:
    return torch.as_tensor(a).cpu().numpy()


def link_churn(prev_edge, in_edge) -> float:
    """Fraction of receivers whose transmitter changed; 0 if no previous."""
    if prev_edge is None:
        return 0.0
    prev_edge = _host(prev_edge)
    in_edge = _host(in_edge)
    return float(np.mean(prev_edge != in_edge))


def link_churn_dev(prev_edge, in_edge):
    """:func:`link_churn` as a device scalar, no host sync."""
    in_edge = torch.as_tensor(in_edge)
    if prev_edge is None:
        return torch.zeros((), device=in_edge.device)
    return torch.mean((torch.as_tensor(prev_edge) != in_edge)
                      .to(torch.float32))


def delivery_stats_dev(in_edge, p_fail):
    """(mean_pfail, expected_delivery) as device scalars over the chosen
    non-self links; matches :func:`delivery_stats`."""
    in_edge = torch.as_tensor(in_edge)
    n = in_edge.shape[0]
    rows = torch.arange(n, device=in_edge.device)
    live = in_edge != rows
    n_live = torch.sum(live)
    pf_live = torch.sum(torch.where(live, p_fail[rows, in_edge],
                                    torch.zeros((), device=p_fail.device)))
    pf = torch.where(n_live > 0, pf_live / torch.clamp_min(n_live, 1),
                     torch.ones((), device=p_fail.device))
    expected = torch.where(n_live > 0, 1.0 - pf,
                           torch.zeros((), device=p_fail.device))
    return pf, expected


def realized_delivery_dev(in_edge, fail):
    """:func:`realized_delivery` from the exchange's device outputs
    (``ExchangeResult.fail``), no host sync; NaN when no link is live (the
    caller maps that to None)."""
    in_edge = torch.as_tensor(in_edge)
    n = in_edge.shape[0]
    live = in_edge != torch.arange(n, device=in_edge.device)
    n_live = torch.sum(live)
    failed = torch.sum(fail & live)
    return torch.where(n_live > 0,
                       1.0 - failed / torch.clamp_min(n_live, 1),
                       torch.full((), float("nan"), device=in_edge.device))


def realized_delivery(in_edge, decisions) -> Optional[float]:
    """Fraction of live links that delivered, from the exchange's
    ``gate_decisions`` — entries ``(rx, tx, cluster, accepted)`` with
    ``cluster == -1`` marking a link whose sampled channel failed.
    None when no sampling ran (``decisions`` is None) or no link is live."""
    if decisions is None:
        return None
    in_edge = _host(in_edge)
    live = in_edge != np.arange(in_edge.shape[0])
    if not live.any():
        return None
    failed_rx = {d[0] for d in decisions if d[2] == -1}
    return 1.0 - len(failed_rx) / max(int(live.sum()), 1)


def delivery_stats(in_edge, p_fail, decisions=None):
    """(mean_pfail, expected, realized) for the chosen links.

    decisions: see :func:`realized_delivery`; None when no channel
    sampling ran."""
    in_edge = _host(in_edge)
    p_fail = _host(p_fail)
    n = in_edge.shape[0]
    live = in_edge != np.arange(n)
    if not live.any():
        return 1.0, 0.0, None
    pf = float(np.mean(p_fail[np.arange(n)[live], in_edge[live]]))
    return pf, 1.0 - pf, realized_delivery(in_edge, decisions)


class Trace:
    """Accumulates SegmentRecords and derives run-level summaries."""

    def __init__(self):
        self.segments: List[SegmentRecord] = []

    def add(self, rec: SegmentRecord):
        self.segments.append(rec)

    @property
    def eval_losses(self) -> np.ndarray:
        return np.asarray([s.eval_loss for s in self.segments])

    @property
    def eval_curve(self) -> np.ndarray:
        """All intra-segment eval points concatenated (the fl_train trace)."""
        parts = [s.eval_curve for s in self.segments if s.eval_curve.size]
        return np.concatenate(parts) if parts else np.zeros(0)

    @property
    def eval_curve_iters(self) -> np.ndarray:
        parts = [s.eval_iters for s in self.segments if s.eval_iters.size]
        return np.concatenate(parts) if parts else np.zeros(0, np.int64)

    def summary(self) -> dict:
        segs = self.segments
        realized = [s.realized_delivery for s in segs
                    if s.realized_delivery is not None]
        n_live = sum(s.n_live for s in segs)
        n_failed = sum(s.n_failed for s in segs)
        retry_delivered = sum(s.retry_delivered for s in segs)
        return {
            "n_segments": len(segs),
            "final_loss": float(segs[-1].eval_loss) if segs else float("nan"),
            "mean_link_churn": float(np.mean(
                [s.link_churn for s in segs[1:]])) if len(segs) > 1 else 0.0,
            "mean_expected_delivery": float(np.mean(
                [s.expected_delivery for s in segs])) if segs else 0.0,
            "mean_realized_delivery": (float(np.mean(realized))
                                       if realized else None),
            "total_moved": int(sum(s.moved for s in segs)),
            "n_rediscoveries": int(sum(s.rediscovered for s in segs)),
            "min_available": int(min((s.n_available for s in segs),
                                     default=0)),
            # fault/retry plane: of every live link the run committed to,
            # what fraction ultimately delivered — first try or on a retry
            # (the resilience number the retry queue is judged by)
            "total_failed_links": int(n_failed),
            "total_retried": int(sum(s.retried for s in segs)),
            "total_retry_delivered": int(retry_delivered),
            "effective_delivery": (
                float((n_live - n_failed + retry_delivered) / n_live)
                if n_live else None),
        }
